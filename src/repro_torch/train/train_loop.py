"""Train-step factories (counterpart of ``repro.train.train_loop``).

``make_train_step(loss_fn, opt_cfg, accum_steps=...)`` builds the step

    grads = autograd(loss); clip; optimizer update

run eagerly, with no compile.  Under accumulation the batch's leading axis
is cut into ``accum_steps`` contiguous microbatches of B / accum_steps rows,
as the reference reshapes it; their gradients and losses are summed in fp32
in microbatch order and divided once.  Accumulation is what bounds memory:
the whole graph of a microbatch is kept for its backward pass.

``make_sharded_train_step(loss_fn, opt_cfg, groups, compress_pod=...)`` is
the reference's two-level data-parallel step, written for
``torch.distributed`` (SPMD: every rank calls it on its own rows):

    grads --mean over the data group (full precision)-->
          --compressed mean over the pod group (int8 + scale)--> update

Parameters and optimizer state stay replicated; each rank holds its own
error residual, the reference's per-pod ``(n_pods, ...)`` leaf seen from
one rank (equal within a pod, since the data-group mean comes first).
``groups`` comes from ``launch.mesh.dp_groups``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

import torch

from repro_torch.core import distributed
from repro_torch.train import compress as compress_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.optimizer import tree_leaves, tree_map

Tree = Any
LossFn = Callable[[Tree, Any], "tuple[torch.Tensor, Dict[str, torch.Tensor]]"]


def _unflatten(tree: Tree, leaves: Iterator[torch.Tensor]) -> Tree:
    """``tree``'s layout filled from ``leaves`` in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def value_and_grad(loss_fn: LossFn, params: Tree, batch) -> tuple:
    """((loss, metrics), grads): the loss and aux metrics detached, the
    gradient of every parameter (zeros where the loss does not reach it)."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(p, batch)
        leaves = tree_leaves(p)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), _unflatten(params, iter(grads))


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split into {n} microbatches")
    m = B // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n)]


def step_grads(loss_fn: LossFn, params: Tree, batch, accum_steps: int = 1) -> tuple:
    """(loss, metrics, grads) of one train step: the whole batch, or the sum
    over ``accum_steps`` contiguous microbatches in fp32, divided once (the
    metrics then hold nothing but what the step adds)."""
    if accum_steps == 1:
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        return loss, metrics, grads
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    for mb in _microbatches(batch, accum_steps):
        (l, _), g = value_and_grad(loss_fn, params, mb)
        tree_map(lambda a, b: a.add_(b.float()), grads, g)
        loss = loss + l
        del g
    return loss / accum_steps, {}, tree_map(lambda g: g / accum_steps, grads)


def make_train_step(loss_fn: LossFn, opt_cfg: opt_lib.OptConfig, *, accum_steps: int = 1):
    """loss_fn(params, batch) -> (loss, metrics).  Returns
    train_step(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def train_step(params, opt_state, batch):
        loss, metrics, grads = step_grads(loss_fn, params, batch, accum_steps)
        params, opt_state, gnorm = opt_lib.apply_updates(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return train_step


def _mean(t: torch.Tensor, group, size: int) -> torch.Tensor:
    return distributed.all_reduce_sum(t, group) / size


def make_sharded_train_step(loss_fn: LossFn, opt_cfg: opt_lib.OptConfig, groups, *,
                            compress_pod: bool = True):
    """The data-parallel step over ``groups`` (``launch.mesh.DPGroups``):
    step(params, opt_state, err, local_batch) -> (params, opt_state, err,
    metrics), ``local_batch`` this rank's rows (``groups.local_rows``) and
    ``err`` from ``init_pod_error_state``."""

    def step(params, opt_state, err, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        # intra-pod reduction: full precision over the data group
        grads = tree_map(lambda g: _mean(g, groups.data, groups.n_data), grads)
        loss = _mean(loss, groups.data, groups.n_data)
        if groups.n_pods > 1:
            if compress_pod:
                grads, err = compress_lib.allreduce_compressed(grads, err, groups.pod)
            else:
                grads = tree_map(lambda g: _mean(g, groups.pod, groups.n_pods), grads)
            loss = _mean(loss, groups.pod, groups.n_pods)
        params, opt_state, gnorm = opt_lib.apply_updates(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return params, opt_state, err, metrics

    return step


def init_pod_error_state(params: Tree) -> Tree:
    """This rank's zero residuals for ``make_sharded_train_step`` (its
    pod's row of the reference's ``(n_pods, *shape)`` leaves)."""
    return compress_lib.init_error_state(params)


def make_eval_step(loss_fn: LossFn):
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = loss_fn(params, batch)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics

    return eval_step
