"""Mixture-of-Experts FFN: top-k routing with sort-based dispatch
(counterpart of ``repro.models.moe``).

Covers mixtral-8x7b (8 experts, top-2) and arctic-480b (128 experts, top-2,
plus a parallel dense residual FFN, in ``models.transformer``).  The
reference's sorted-capacity scheme, step for step:

  route -> flatten (token, expert) assignments -> stable sort by expert ->
  segment rank -> keep rank < capacity -> gather to (E, C, d) -> grouped
  GEMMs -> gate-weighted scatter-add back.

Ties: ``lax.top_k`` puts the lower expert first among equal
probabilities, as a stable descending sort does; ``torch.topk`` promises no
order and is not used.  Tokens dropped at capacity overflow are counted in
the aux metrics; the load-balancing loss is the Switch/GShard form.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import segments
from repro_torch.models import common, sharding
from repro_torch.models.sharding import batch_axes, constrain


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int, cfg: MoEConfig,
                    dtype) -> Dict[str, torch.Tensor]:
    """The reference's leaves, drawn in a fixed order from one generator (the
    router in fp32 whatever ``dtype``)."""
    E = cfg.n_experts
    return {
        "router": common.dense_init(generator, (d_model, E), torch.float32),
        "w_gate": common.dense_init(generator, (E, d_model, d_ff), dtype),
        "w_up": common.dense_init(generator, (E, d_model, d_ff), dtype),
        "w_down": common.dense_init(generator, (E, d_ff, d_model), dtype),
    }


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``einsum("ecd,edf->ecf")``: mixed operands (bf16
    tokens against fp32 smoke weights) promote, as in JAX."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.bmm(a.to(dt), b.to(dt))


def _rank_groups(params, x: DTensor, groups: int, cfg: MoEConfig, act: str, capacity):
    """``groups`` contiguous token groups of the DTensor ``x`` (T, d), split
    over the data axes and whole over the others (the reference's
    ``constrain(..., "batch", None, None)``; one group: whole everywhere),
    each rank dispatching its own groups (the reference's shard-local
    ``vmap``).  A rank's group runs as a DTensor replicated over the mesh:
    its value differs between data ranks while the program does not.  The
    outputs and the aux values come back split over the data axes, the aux
    means taken over every group."""
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    rep = [Replicate()] * len(names)
    rows = [Shard(0) if groups > 1 and n in batch_axes(mesh) else Replicate() for n in names]
    T, d = x.shape
    local = x.redistribute(mesh, rows).to_local()
    outs, auxs = [], []
    for xx in local.reshape(-1, T // groups, d):
        o, a = _dispatch(params, DTensor.from_local(xx, mesh, rep, run_check=False), cfg,
                         act, capacity)
        outs.append(o.redistribute(mesh, rep).to_local())
        auxs.append({k: v.redistribute(mesh, rep).to_local() for k, v in a.items()})
    out = DTensor.from_local(torch.stack(outs).reshape(-1, d), mesh, rows, run_check=False,
                             shape=x.shape, stride=(d, 1))
    aux = {k: DTensor.from_local(torch.stack([a[k] for a in auxs]), mesh, rows, run_check=False,
                                 shape=torch.Size((groups,)), stride=(1,)).mean()
           for k in auxs[0]}
    return out, aux


def apply_moe(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (T, d) — flattened tokens
    cfg: MoEConfig,
    *,
    act: str = "silu",
    capacity: Optional[int] = None,
    groups: int = 1,
) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (output (T, d), aux dict with load-balance loss + drop rate).

    ``groups > 1`` runs the dispatch independently per contiguous token
    group (the reference's ``vmap``, here a loop), each with its own
    capacity, and averages the aux values over the groups; the group axis
    is constrained over the data axes (the identity off a mesh).
    """
    T, d = x.shape
    grouped = groups > 1 and T % groups == 0 and T // groups >= 8
    if isinstance(x, DTensor):
        return _rank_groups(params, x, groups if grouped else 1, cfg, act, capacity)
    if grouped:
        xg = constrain(x.reshape(groups, T // groups, d), "batch", None, None)
        outs, auxs = zip(*(apply_moe(params, xx, cfg, act=act, capacity=capacity) for xx in xg))
        out = constrain(torch.stack(outs), "batch", None, None).reshape(T, d)
        return out, {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    return _dispatch(params, x, cfg, act, capacity)


def _dispatch(params, x: torch.Tensor, cfg: MoEConfig, act: str, capacity: Optional[int]):
    """One group's routing, dispatch, expert GEMMs and scatter back."""
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if capacity is None:
        capacity = int(cfg.capacity_factor * T * K / E)
        capacity = max(8, -(-capacity // 8) * 8)
    C = capacity

    acc = torch.promote_types(x.dtype, torch.float32)
    logits = x.to(acc) @ params["router"].to(acc)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = top.values[:, :K], top.indices[:, :K]  # (T, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # ---- flatten assignments and sort by expert -----------------------------
    flat_e = expert_ids.reshape(-1)  # (T*K,)
    flat_t = torch.arange(T, device=x.device)[:, None].expand(T, K).reshape(-1)
    flat_g = gate_vals.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]

    # ---- gather tokens into (E, C, d) ---------------------------------------
    # T is the token sentinel -> zero row of xz
    (buf_tok, buf_gate), counts = segments.grouped_top_r(se, [st, sg], [T, 0.0], E, C)
    dropped = torch.clamp(counts - C, min=0).sum()
    drop_rate = dropped.to(torch.float32) / se.shape[0]
    xz = torch.cat([x, torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    xe = xz[buf_tok]  # (E, C, d)

    # ---- grouped expert GEMMs ----------------------------------------------
    fn = common.ACTIVATIONS[act]
    h = fn(_bmm(xe, params["w_gate"])) * _bmm(xe, params["w_up"])
    ye = _bmm(h, params["w_down"])  # (E, C, d)

    # ---- weighted scatter back ----------------------------------------------
    # Row T takes the empty slots and is dropped.  A token row receives at
    # most top_k addends (one per expert it was routed to and kept by), added
    # to zero: with top_k = 2, 0 + a + b equals 0 + b + a exactly, so the
    # order the card's atomics add in changes no bit.
    ye = ye * buf_gate[..., None].to(ye.dtype)
    if isinstance(ye, DTensor):
        out = sharding.index_add_rows(ye.reshape(-1, d), buf_tok.reshape(-1), T + 1)[:T]
    else:
        out = torch.zeros((T + 1, d), dtype=ye.dtype, device=x.device)
        out = out.index_add(0, buf_tok.reshape(-1), ye.reshape(-1, d))[:T]

    # ---- aux load-balancing loss (Switch eq. 4-6) ---------------------------
    # fraction of tokens routed to e (top-1 assignment) * mean router prob
    top1 = expert_ids[:, 0]
    frac = torch.nn.functional.one_hot(top1, E).to(probs.dtype).mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux_loss = cfg.aux_loss_weight * E * torch.sum(frac * mean_prob)
    return out.to(x.dtype), {"moe_aux_loss": aux_loss, "moe_drop_rate": drop_rate}
