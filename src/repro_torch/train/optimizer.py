"""Optimizers as plain functions on dicts of tensors (counterpart of
``repro.train.optimizer``): AdamW, (factored) Adafactor and SGD.

A parameter tree is a dict whose values are tensors or dicts of the same
kind.  ``init_opt_state`` makes the state the reference makes (AdamW:
``m``, ``v``, ``step``; Adafactor: ``vr``, ``vc``, ``step``; SGD:
``step``), ``step`` an int32 scalar tensor; ``apply_updates`` clips by the
global norm and applies one update, returning new trees and never writing
into the ones it was given.

These are not ``torch.optim``: ``torch.optim.AdamW`` decays before the step
and adds eps after dividing by √bc2, and clips per call, so it rounds
differently.  Here every operation is the reference's, in its order, in
fp32: the global norm sums the leaves in ``jax.tree_util.tree_leaves``
order (dict keys sorted at every level), and AdamW decays every row of an
embedding table, the rows a batch did not touch included, as the
reference's dense update does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # "adamw" | "adafactor" | "sgd"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    min_dim_factored: int = 128  # only factor matrices at least this big
    decay_offset: int = 0


# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in ``jax.tree_util.tree_leaves`` order: dict keys sorted
    at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same layout)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _unzip(out: Tree, n: int) -> tuple:
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda o, i=i: o[i], out) for i in range(n))


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _global_norm(tree: Tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _zeros(p: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.zeros(p.shape if shape is None else shape, dtype=torch.float32, device=p.device)


def _step0(params: Tree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _adamw_init(params: Tree) -> Dict[str, Any]:
    return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params), "step": _step0(params)}


def _adamw_update(params, grads, state, cfg: OptConfig):
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_scalar(cfg.b1, t), t)
    bc2 = 1.0 - torch.pow(_scalar(cfg.b2, t), t)

    def upd(p, g, m, v):
        g32 = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - cfg.lr * delta).to(p.dtype), m, v

    new_p, new_m, new_v = _unzip(tree_map(upd, params, grads, state["m"], state["v"]), 3)
    return new_p, {"m": new_m, "v": new_v, "step": step}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum)
# ---------------------------------------------------------------------------


def _factorable(p: torch.Tensor) -> bool:
    return p.ndim >= 2 and p.shape[-1] >= 128 and p.shape[-2] >= 128


def _adafactor_init(params: Tree) -> Dict[str, Any]:
    def vr(p):
        return _zeros(p, p.shape[:-1]) if _factorable(p) else _zeros(p, (1,))  # row stats

    def vc(p):
        # column stats, or the unfactored full second moment
        return _zeros(p, p.shape[:-2] + p.shape[-1:]) if _factorable(p) else _zeros(p)

    return {"vr": tree_map(vr, params), "vc": tree_map(vc, params), "step": _step0(params)}


def _adafactor_update(params, grads, state, cfg: OptConfig):
    step = state["step"] + 1
    t = step.to(torch.float32)
    beta2 = 1.0 - torch.pow(t, -0.8)  # Adafactor's decay schedule

    def upd(p, g, vr, vc):
        g32 = g.float()
        g2 = g32 * g32 + 1e-30
        if _factorable(p):
            vr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
            vhat = r[..., None] * vc[..., None, :]
        else:
            vc = beta2 * vc + (1 - beta2) * g2
            vhat = vc
        u = g32 / torch.sqrt(vhat + 1e-30)
        # update clipping (RMS <= 1)
        rms = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        delta = cfg.lr * u + cfg.lr * cfg.weight_decay * p.float()
        return (p.float() - delta).to(p.dtype), vr, vc

    new_p, new_vr, new_vc = _unzip(tree_map(upd, params, grads, state["vr"], state["vc"]), 3)
    return new_p, {"vr": new_vr, "vc": new_vc, "step": step}


# ---------------------------------------------------------------------------
# SGD (tests / toy examples)
# ---------------------------------------------------------------------------


def _sgd_init(params: Tree) -> Dict[str, Any]:
    return {"step": _step0(params)}


def _sgd_update(params, grads, state, cfg: OptConfig):
    new = tree_map(lambda p, g: (p.float() - cfg.lr * g.float()).to(p.dtype), params, grads)
    return new, {"step": state["step"] + 1}


_OPTS = {
    "adamw": (_adamw_init, _adamw_update),
    "adafactor": (_adafactor_init, _adafactor_update),
    "sgd": (_sgd_init, _sgd_update),
}


def opt_state_pspecs(param_specs: Tree, params_shape: Tree, cfg: OptConfig) -> Tree:
    """The optimizer state's specs (``models.sharding``), mirroring the
    parameters' ``param_specs``; ``params_shape`` is the parameter tree (or
    any tree of tensors of the same shapes).  AdamW's moments take the
    parameters' specs; Adafactor's factored row statistics drop the last
    dimension's entry and its column statistics the second to last, an
    unfactored leaf keeping a full second moment (``vc``) beside a
    one-element ``vr``; the step is replicated."""
    if cfg.name == "adamw":
        return {"m": param_specs, "v": param_specs, "step": ()}
    if cfg.name == "adafactor":
        def parts(spec, p):
            return tuple(spec) + (None,) * (p.dim() - len(spec))

        def vr_spec(spec, p):
            return parts(spec, p)[:-1] if _factorable(p) else (None,)

        def vc_spec(spec, p):
            full = parts(spec, p)
            return full[:-2] + full[-1:] if _factorable(p) else full

        # a spec tuple is a leaf of ``tree_map``, which recurses into dicts only
        return {"vr": tree_map(vr_spec, param_specs, params_shape),
                "vc": tree_map(vc_spec, param_specs, params_shape), "step": ()}
    return {"step": ()}


def init_opt_state(params: Tree, cfg: OptConfig) -> Tree:
    return _OPTS[cfg.name][0](params)


@torch.no_grad()
def apply_updates(params: Tree, grads: Tree, state: Tree, cfg: OptConfig):
    """(new params, new state, global norm of the unclipped grads)."""
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = _global_norm(grads)
    params, state = _OPTS[cfg.name][1](params, grads, state, cfg)
    return params, state, gnorm
