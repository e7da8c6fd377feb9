"""Train a ~100M-parameter decoder LM for a few hundred steps on the
PyTorch port (the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] [--tiny]
    PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu

The port's substrate end to end: a gemma3-style local:global config, AdamW,
the deterministic skip-ahead loader and a checkpoint every 100 steps (in
the reference's layout, ``launch.train``'s).  ``--tiny`` drops to a 2M
model for quick runs.  It runs on the card unless given ``--device cpu``,
and fails unless the loss falls.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import device as device_lib
from repro_torch.data import loader
from repro_torch.launch.train import flatten
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import train_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_config(tiny: bool) -> tfm.TransformerConfig:
    if tiny:
        return tfm.TransformerConfig(
            name="lm-2m", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
            d_ff=256, vocab=2048, local_global=(1, 1), local_window=64,
            remat=False, q_chunk=64, kv_chunk=64,
        )
    # ~100M params: 12L x 768, vocab 32k (GPT-2-small-ish with GQA + SWA mix)
    return tfm.TransformerConfig(
        name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab=32_000, local_global=(3, 1), local_window=256,
        remat=False, q_chunk=128, kv_chunk=128,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt", default=None, help="default: build/lm_ckpt in the repository")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)

    cfg = make_config(args.tiny)
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    print(f"model {cfg.name}: {common.count_params(params) / 1e6:.1f}M params on {dev}")

    ocfg = opt_lib.OptConfig(name="adamw", lr=3e-4 if not args.tiny else 3e-3)
    opt_state = opt_lib.init_opt_state(params, ocfg)
    step_fn = train_loop.make_train_step(lambda p, b: tfm.loss_fn(p, b["tokens"], cfg), ocfg)
    data = loader.lm_batches(args.batch, args.seq, cfg.vocab, device=dev)

    ckpt_dir = args.ckpt or os.path.join(ROOT, "build", "lm_ckpt")
    t0 = time.perf_counter()
    first = last = None
    for step in range(args.steps):
        params, opt_state, m = step_fn(params, opt_state, data.batch(step))
        last = float(m["loss"])
        first = last if first is None else first
        if step % 20 == 0:
            tok_s = (step + 1) * args.batch * args.seq / (time.perf_counter() - t0)
            print(f"step {step:4d} loss {last:.4f} ({tok_s:,.0f} tok/s)", flush=True)
        if (step + 1) % 100 == 0:
            ckpt_lib.save(ckpt_dir, flatten({"0": params, "1": opt_state}), step=step + 1)
    secs = time.perf_counter() - t0
    print(f"done: loss {first:.3f} -> {last:.3f} over {args.steps} steps in {secs:.1f}s; "
          f"checkpoints in {ckpt_dir}")
    if not last < first:
        raise RuntimeError(f"loss must decrease: {first:.4f} -> {last:.4f}")
    return {"first": first, "last": last, "seconds": secs, "params": params}


if __name__ == "__main__":
    main()
