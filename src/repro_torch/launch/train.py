"""Training launcher of the port (counterpart of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch deepfm \\
        --steps 200 --batch 8 --ckpt build/ck --ckpt-every 50

Runs a training loop for the LM (``gemma3-1b``, ``stablelm-1.6b``,
``qwen2.5-3b``, ``mixtral-8x7b``, ``arctic-480b``: next-token loss over
``loader.lm_batches`` of ``--batch`` x ``--seq`` tokens), recommender
(``deepfm``, ``xdeepfm``, ``bst``, ``mind``) and GNN (``mace``) families:
the eager train step
(``train.train_loop``), AdamW, deterministic skip-ahead batches
(``data.loader``), periodic checkpoints and resume.  The smoke config by
default; ``--full-config`` the published one.  ``--accum-steps`` splits
each batch into microbatches, which is what bounds memory at full width.
It runs on the card unless given ``--device cpu``.

Checkpoints hold ``(params, opt_state)`` in the reference's layout (leaf
``0/<param>`` and ``1/m/<param>``, ``1/v/<param>``, ``1/step``), so one
written by ``repro.launch.train`` restores here and the other way round
(bf16 leaves, the full LM configs', are written widened to fp32).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from repro_torch import configs
from repro_torch import device as device_lib
from repro_torch.data import loader, recsys_data
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop

# the reference draws the parameters from PRNGKey(0) and the GNN's graph
# from PRNGKey(1); here, generators seeded the same
PARAM_SEED, GRAPH_SEED = 0, 1
GNN_NODES, GNN_EDGES = 256, 2048


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> {"a/b/c": leaf}, the reference's checkpoint names."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(flatten(v, name + "/") if isinstance(v, dict) else {name: v})
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def setup(arch: str, *, full: bool, batch: int, dev: torch.device, seq: int = 128):
    """(params, loss_fn, loader) of one arch on ``dev``."""
    mod = configs.get(arch)
    gen = torch.Generator(device=dev).manual_seed(PARAM_SEED)
    if mod.FAMILY == "lm":
        from repro_torch.models import transformer as tfm

        cfg = mod.full_config() if full else mod.smoke_config()
        params = tfm.init_params(gen, cfg)

        def loss(p, b):
            return tfm.loss_fn(p, b["tokens"], cfg)

        return params, loss, loader.lm_batches(batch, seq, cfg.vocab, device=dev)
    if mod.FAMILY == "recsys":
        from repro_torch.models import recsys as rec

        cfg = mod.full_config() if full else mod.smoke_config()
        params = rec.init_params(gen, cfg)

        def loss(p, b):
            return rec.loss_fn(p, b, cfg)

        if cfg.name in ("deepfm", "xdeepfm"):
            def fn(g):
                return recsys_data.ctr_batch(g, batch, cfg.n_sparse, cfg.vocab_per_field)
        else:
            def fn(g):
                return recsys_data.behavior_batch(g, batch, cfg.seq_len, cfg.vocab_per_field)
        return params, loss, loader.LoaderSpec(fn, device=dev)
    if mod.FAMILY == "gnn":
        from repro_torch.data import graphs
        from repro_torch.models import mace as mace_lib

        shape = "full_graph_sm"
        cfg = mod.full_config(shape) if full else mod.smoke_config(shape)
        params = mace_lib.init_params(gen, cfg)
        g = graphs.random_graph(torch.Generator(device=dev).manual_seed(GRAPH_SEED), GNN_NODES,
                                GNN_EDGES, cfg.d_node_feat, n_classes=cfg.n_classes)
        static = dict(
            positions=torch.zeros((GNN_NODES, 3), device=dev),
            species=torch.zeros((GNN_NODES,), dtype=torch.int32, device=dev),
            senders=g.senders, receivers=g.receivers, node_feat=g.features, labels=g.labels,
        )

        def loss(p, b):
            return mace_lib.node_class_loss(p, b, cfg)

        return params, loss, loader.LoaderSpec(lambda _g: static, device=dev)
    raise SystemExit(f"--arch {arch}: use launch.build_graph for knn archs")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="one of " + ", ".join(configs.names(False)))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128, help="LM sequence length")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="microbatches per step (the batch must divide)")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    mod = configs.get(args.arch)
    dev = device_lib.resolve(args.device)
    params, loss, data = setup(args.arch, full=args.full_config, batch=args.batch, dev=dev,
                               seq=args.seq)
    ocfg = opt_lib.OptConfig(name="adamw", lr=args.lr)
    opt_state = opt_lib.init_opt_state(params, ocfg)
    step_fn = train_loop.make_train_step(loss, ocfg, accum_steps=args.accum_steps)

    start = 0
    if args.resume and args.ckpt and os.path.exists(os.path.join(args.ckpt, ckpt_lib.MANIFEST)):
        like = flatten({"0": params, "1": opt_state})
        flat, start = ckpt_lib.restore(args.ckpt, like, device=dev)
        state = unflatten(flat)
        params, opt_state = state["0"], state["1"]
        print(f"resumed from step {start}")

    print(f"training {args.arch} ({mod.FAMILY}) on {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""), flush=True)
    t0 = time.perf_counter()
    m = {}
    for step in range(start, args.steps):
        params, opt_state, m = step_fn(params, opt_state, data.batch(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            ms = {k: float(v) for k, v in m.items()}
            print(f"step {step:5d} " + " ".join(f"{k}={v:.4f}" for k, v in ms.items()),
                  flush=True)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt, flatten({"0": params, "1": opt_state}), step=step + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    print(f"trained {args.steps - start} steps in {secs:.1f}s")
    return {"params": params, "opt_state": opt_state, "metrics": m, "start": start,
            "seconds": secs, "device": str(dev)}


if __name__ == "__main__":
    main()
