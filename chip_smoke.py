#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

needs one NVIDIA card and runs, in order:

1. the card's name and power limit (``nvidia-smi``);
2. builds the three hand-written kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together) and holds each kernel
   against its plain PyTorch version on the card: at a small shape for each
   of the five metrics and at the main path's shapes, distances to
   ``rtol=1e-5, atol=1e-3`` on Gaussian data and bit for bit on
   integer-valued data; prints each kernel's time, its plain version's time
   and, for ``pairwise_distance``, ``torch.cdist`` as a yardstick;
3. an n=20,000, d=32 integer-valued build with the kernels and the same
   build with the plain versions, from the same injected seeds: every graph
   array and the counters must be identical;
4. the online LGD build at full width (the knn-lgd config: k=20, l2, W=4096,
   beam 40, 8 seeds, d=128) over n=1,000,000 clustered rows, then graph
   recall@10 over 10,000 strided rows against ``brute_force_knn`` run
   through the pairwise kernel, self-match excluded; then the same build
   through the plain versions on the card, same data and seeds.  The
   kernels' recall must reach 0.90, or, where the plain build misses 0.90
   too (the algorithm's own floor at this wave width), the plain recall
   less 0.01;
5. a ``kernels`` JSON line (every kernel's launches on the main path of
   phase 4, its error against the plain version, times and bound).

It exits non-zero, printing no result, when any phase fails, when no CUDA
device is present, or when it is run without the rest of the repository.
The last line of its output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the fp32
# CUDA-core rate (the fp32 kernels use no tensor cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

RTOL, ATOL = 1e-5, 1e-3
# ~0.1 s at the H100's clock: longer than the host takes to queue one timing
SPIN_CYCLES = 200_000_000
METRICS = ("l2", "ip", "cosine", "l1", "chi2")
EXACT_METRICS = ("l2", "ip", "l1")  # exact fp32 sums on integer-valued data

# the TPU kernels' pallas_call sites, and the CUDA sources that replace them
KERNELS = {
    "gather_distance": ("src/repro_torch/csrc/gather_dist.cu", "src/repro/kernels/gather_dist.py:329"),
    "fused_expand": ("src/repro_torch/csrc/expand.cu", "src/repro/kernels/expand.py:412"),
    "pairwise_distance": ("src/repro_torch/csrc/distance.cu", "src/repro/kernels/distance.py:223"),
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    print(f"device: {smi}", flush=True)
    smoke = Smoke(torch)
    try:
        smoke.build_kernels()
        smoke.phase_kernels()
        smoke.phase_build_parity()
        smoke.phase_full()
    except PhaseError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": smoke.kernel_records()}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.rec = {name: {"max_abs_err": 0.0} for name in KERNELS}
        from repro_torch.kernels import _cuda, ops

        self._cuda, self.ops = _cuda, ops

    # ------------------------------------------------------------------ utils
    def gen(self, seed):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

    def time_ms(self, fns, warmup=2):
        """Mean device time of one call, over calls fns[0], fns[1], ...
        (CUDA events around the whole run, after warm-up calls).  A spin
        kernel holds the stream while the host queues the calls, so the
        events time the device's work back to back and not the host's rate
        of launching it (unless a call waits on the device itself)."""
        torch = self.torch
        for f in fns[:warmup]:
            f()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for f in fns[warmup:]:
            f()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (len(fns) - warmup)

    def compare(self, kernel, got, want, *, exact, what):
        torch = self.torch
        got, want = got.float(), want.float()
        check(got.shape == want.shape, f"{kernel} {what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        fin = torch.isfinite(want)
        check(torch.equal(fin, torch.isfinite(got)), f"{kernel} {what}: +inf pattern differs")
        err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
        if exact:
            check(torch.equal(got, want), f"{kernel} {what}: not bit-identical (max err {err})")
        else:
            ok = torch.allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)
            check(ok, f"{kernel} {what}: max abs err {err} beyond rtol={RTOL} atol={ATOL}")
            self.rec[kernel]["max_abs_err"] = max(self.rec[kernel]["max_abs_err"], err)

    def data(self, n, d, seed, *, integer=False, metric="l2"):
        torch = self.torch
        g = self.gen(seed)
        if integer:
            return torch.randint(0, 16, (n, d), generator=g, device=self.dev).float()
        x = torch.randn((n, d), generator=g, device=self.dev)
        return x.abs() if metric == "chi2" else x

    # ---------------------------------------------------------------- phase 1
    def build_kernels(self):
        t0 = time.perf_counter()
        built = self._cuda.build()
        print(f"kernels built in {time.perf_counter() - t0:.3f} s: "
              + ", ".join(sorted(built)), flush=True)

    # ---------------------------------------------------------------- phase 2
    def phase_kernels(self):
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core.graph import squared_norms
        from repro_torch.launch import build_graph
        from repro_torch.kernels import distance, expand, gather_dist, ref

        t0 = time.perf_counter()
        for metric in METRICS:
            for integer in (False, True):
                exact = integer and metric in EXACT_METRICS
                for d in (72, 70):  # float4 path and scalar path
                    x = self.data(500, d, 1, integer=integer, metric=metric)
                    q = self.data(33, d, 2, integer=integer, metric=metric)
                    sq = squared_norms(x)
                    idx = torch.randint(-1, 500, (33, 19), generator=self.gen(3), device=self.dev).int()
                    what = f"{metric} d={d} {'int' if integer else 'gauss'}"
                    self.compare("gather_distance",
                                 gather_dist.gather_distance(q, x, idx, metric, sq_norms=sq),
                                 ref.gather_distance(q, x, idx, metric, sq_norms=sq),
                                 exact=exact, what=what)
                    for xn in ((None, sq) if metric == "l2" else (None,)):
                        self.compare("pairwise_distance",
                                     distance.pairwise_distance(q, x[:130], metric, x_sq_norms=None if xn is None else xn[:130]),
                                     ref.pairwise_distance(q, x[:130], metric, x_sq_norms=None if xn is None else xn[:130]),
                                     exact=exact, what=what + (" cached" if xn is not None else ""))
                    self.check_expand(x, q, sq, metric, integer, B=33, C=23, e=16, H=64, P=4, steps=3)
        print(f"phase 2a: small shapes, five metrics: kernels agree with plain "
              f"({time.perf_counter() - t0:.3f} s)", flush=True)

        # main-path shapes (l2, d=128): seed gather B=4096 C=8, expansion
        # B=4096 C=60 e=40 H=2048 P=8, intra-wave tile 4096², brute tile
        d = knn_lgd.D
        xf = build_graph.make_data(knn_lgd.N_ROWS, d, "l2", self.dev)
        xi = self.data(200_000, d, 8, integer=True)
        for x, integer in ((xf, False), (xi, True)):
            sq = squared_norms(x)
            q = x[torch.randint(0, x.shape[0], (4096,), generator=self.gen(9), device=self.dev)]
            idx = torch.randint(0, x.shape[0], (4096, 8), generator=self.gen(10), device=self.dev).int()
            got = gather_dist.gather_distance(q, x, idx, "l2", sq_norms=sq)
            self.compare("gather_distance", got, ref.gather_distance(q, x, idx, "l2", sq_norms=sq),
                         exact=integer, what=f"main shape {'int' if integer else 'clustered'}")
            if not integer:
                self.time_gather(q, x, idx, sq)
            self.check_expand(x, q, sq, "l2", integer, B=4096, C=60, e=40, H=2048, P=8,
                              steps=1, timed=not integer)
            xq = x[:4096]
            sqq = sq[:4096]
            got = distance.pairwise_distance(xq, xq, "l2", x_sq_norms=sqq)
            self.compare("pairwise_distance", got, ref.pairwise_distance(xq, xq, "l2", x_sq_norms=sqq),
                         exact=integer, what=f"intra-wave tile {'int' if integer else 'clustered'}")
            if not integer:
                self.time_pairwise(xq, xq, sqq, main=True)
                self.time_pairwise(x[::100][:10_000].contiguous(), x[:8192], sq[:8192], main=False)
        self.xf = xf
        print("phase 2b: main-path shapes: kernels agree with plain", flush=True)

    def time_gather(self, q, x, idx, sq):
        from repro_torch.kernels import gather_dist, ref

        ms = self.time_ms([lambda: gather_dist.gather_distance(q, x, idx, "l2", sq_norms=sq)] * 22)
        plain_ms = self.time_ms([lambda: ref.gather_distance(q, x, idx, "l2", sq_norms=sq)] * 12)
        B, C = idx.shape
        d = x.shape[1]
        valid = int((idx >= 0).sum())
        b, how = bound(4 * (B * d + B * C + valid * d + valid + B * C), 2 * d * valid)
        self.rec["gather_distance"].update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=how,
                                           library_ms=None, shape=f"B={B} C={C} d={d}")
        print(f"gather_distance B={B} C={C} d={d}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {b:.6f} ms ({how})", flush=True)

    def time_pairwise(self, q, x, xn, *, main):
        torch = self.torch
        from repro_torch.kernels import distance, ref

        m, d = q.shape
        n = x.shape[0]
        ms = self.time_ms([lambda: distance.pairwise_distance(q, x, "l2", x_sq_norms=xn)] * 12)
        plain_ms = self.time_ms([lambda: ref.pairwise_distance(q, x, "l2", x_sq_norms=xn)] * 12)
        lib_ms = self.time_ms([lambda: torch.cdist(q, x)] * 12)
        b, how = bound(4 * (m * d + n * d + n + m * n), 2 * m * n * d)
        print(f"pairwise_distance m={m} n={n} d={d}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"torch.cdist {lib_ms:.6f} ms, bound {b:.6f} ms ({how})", flush=True)
        if main:
            self.rec["pairwise_distance"].update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=how,
                                                 library_ms=lib_ms, shape=f"m=n={m} d={d} cached l2")

    def expand_state(self, x, q, sq, metric, B, C, e, H, P, warm):
        """A mid-search state: ``warm`` plain expansion steps from random
        candidates, then candidates half already visited, some -1."""
        torch = self.torch
        from repro_torch.kernels import expand

        n = x.shape[0]
        g = self.gen(11)
        beam_ids = torch.full((B, e), -1, dtype=torch.int32, device=self.dev)
        beam_dist = torch.full((B, e), float("inf"), device=self.dev)
        beam_exp = torch.ones((B, e), dtype=torch.bool, device=self.dev)
        vis_ids = torch.full((B, H), -1, dtype=torch.int32, device=self.dev)
        vis_dist = torch.full((B, H), float("inf"), device=self.dev)

        def cands():
            c = torch.randint(0, n, (B, C), generator=g, device=self.dev).int()
            seen = torch.gather(vis_ids, 1, torch.randint(0, H, (B, C), generator=g, device=self.dev))
            half = torch.rand((B, C), generator=g, device=self.dev) < 0.5
            c = torch.where(half & (seen >= 0), seen, c)
            return torch.where(torch.rand((B, C), generator=g, device=self.dev) < 0.15, -1, c)

        for _ in range(warm):
            beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, _ = expand.expand_reference(
                q, x, cands(), beam_ids, beam_dist, beam_exp, vis_ids, vis_dist,
                metric=metric, probes=P, sq_norms=sq)
        return cands(), beam_ids, beam_dist, beam_exp, vis_ids, vis_dist

    def check_expand(self, x, q, sq, metric, integer, *, B, C, e, H, P, steps, timed=False):
        from repro_torch.kernels import expand

        exact = integer and metric in EXACT_METRICS
        state = self.expand_state(x, q, sq, metric, B, C, e, H, P, warm=2 if H < 1024 else 6)
        if timed:
            self.time_expand(x, q, sq, state, P)
        for step in range(steps):
            cands, bi, bd, be, vi, vd = state
            kw = dict(metric=metric, probes=P, sq_norms=sq)
            got = expand.fused_expand(q, x, cands, bi, bd, be, vi.clone(), vd.clone(), **kw)
            want = expand.expand_reference(q, x, cands, bi, bd, be, vi.clone(), vd.clone(), **kw)
            what = f"{metric} B={B} C={C} e={e} H={H} step {step} {'int' if integer else 'float'}"
            # the hash ids and comps never depend on distance values
            for i, name in ((3, "vis_ids"), (5, "comps")):
                self.compare("fused_expand", got[i], want[i], exact=True, what=f"{what} {name}")
            for i, name in ((1, "beam_dist"), (4, "vis_dist")):
                self.compare("fused_expand", got[i], want[i], exact=exact, what=f"{what} {name}")
            if integer:
                for i, name in ((0, "beam_ids"), (2, "beam_exp")):
                    self.compare("fused_expand", got[i], want[i], exact=True, what=f"{what} {name}")
            state = (cands.roll(1, dims=1),) + tuple(want[:5])

    def time_expand(self, x, q, sq, state, P):
        from repro_torch.kernels import expand

        cands, bi, bd, be, vi, vd = state
        kw = dict(metric="l2", probes=P, sq_norms=sq)
        reps = 12
        # every call gets its own copy of the hash it updates in place
        hashes = [(vi.clone(), vd.clone()) for _ in range(reps)]
        ms = self.time_ms([lambda h=h: expand.fused_expand(q, x, cands, bi, bd, be, *h, **kw)
                           for h in hashes])
        hashes = [(vi.clone(), vd.clone()) for _ in range(reps)]
        plain_ms = self.time_ms([lambda h=h: expand.expand_reference(q, x, cands, bi, bd, be, *h, **kw)
                                 for h in hashes])
        out = expand.expand_reference(q, x, cands, bi, bd, be, vi.clone(), vd.clone(), **kw)
        B, C = cands.shape
        e, d = bi.shape[1], x.shape[1]
        fresh = int(out[5].sum())
        valid = int((cands >= 0).sum())
        inserted = int((out[3] >= 0).sum() - (vi >= 0).sum())
        nbytes = (4 * (B * d + B * C + fresh * d + fresh) + 4 * valid * P + 8 * inserted
                  + 2 * B * e * 9 + 4 * B)
        b, how = bound(nbytes, 2 * d * fresh)
        self.rec["fused_expand"].update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=how,
                                        library_ms=None,
                                        shape=f"B={B} C={C} e={e} H={vi.shape[1]} P={P} d={d}")
        print(f"fused_expand B={B} C={C} e={e} H={vi.shape[1]} P={P} d={d} "
              f"(fresh {fresh}, inserted {inserted}): kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {b:.6f} ms ({how})", flush=True)

    # ---------------------------------------------------------------- phase 3
    @contextlib.contextmanager
    def plain_versions(self):
        """Route the build through the plain versions (on the card)."""
        from repro_torch.kernels import expand, ref

        ops = self.ops
        saved = (ops.pairwise_distance, ops.gather_distance, ops.expand_step)

        def expand_step(*args, hash_probes=8, **kw):
            return expand.expand_reference(*args, probes=hash_probes, **kw)

        ops.pairwise_distance, ops.gather_distance, ops.expand_step = (
            ref.pairwise_distance, ref.gather_distance, expand_step)
        try:
            yield
        finally:
            ops.pairwise_distance, ops.gather_distance, ops.expand_step = saved

    def phase_build_parity(self):
        torch = self.torch
        from repro_torch import convert
        from repro_torch.configs import knn_lgd
        from repro_torch.core import construct

        n, d = 20_000, 32
        x = self.data(n, d, 12, integer=True)
        cfg = dataclasses.replace(knn_lgd.full_config(), wave=1024)

        def seed_fn(wave, pos, W, n_valid):
            g = torch.Generator().manual_seed(1000 + wave)
            return torch.randint(0, max(n_valid, 1), (W, cfg.n_seeds), generator=g, dtype=torch.int32)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, st = construct.build(x, cfg, seed_fn=seed_fn, device=self.dev)
            torch.cuda.synchronize()
            return g, st, time.perf_counter() - t0

        g_k, st_k, t_k = run()
        with self.plain_versions():
            g_p, st_p, t_p = run()
        a, b = convert.graph_to_numpy(g_k), convert.graph_to_numpy(g_p)
        for name in a:
            check((a[name] == b[name]).all(), f"n={n} build: field {name} differs, kernels vs plain")
        for name in ("n_comps", "n_inserted_edges"):
            check(int(getattr(st_k, name)) == int(getattr(st_p, name)),
                  f"n={n} build: {name} differs, kernels vs plain")
        print(f"phase 3: n={n} d={d} integer build, W={cfg.wave}: graph arrays, n_comps="
              f"{int(st_k.n_comps)} and edges identical, kernels vs plain "
              f"(kernels {t_k:.3f} s, plain {t_p:.3f} s)", flush=True)

    # ---------------------------------------------------------------- phase 4
    def phase_full(self):
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import brute, construct, graph as graph_lib
        from repro_torch.launch import build_graph

        x = self.xf  # the launcher's rows, which phase 2 gathered from
        n = x.shape[0]
        cfg = knn_lgd.full_config()

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g, stats = construct.build(x, cfg, generator=self.gen(build_graph.BUILD_SEED),
                                       device=self.dev)
            torch.cuda.synchronize()
            return g, stats, time.perf_counter() - t0

        torch.cuda.reset_peak_memory_stats()
        self.ops.reset_launch_counts()
        g, stats, t_build = run()
        peak = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        rows = torch.arange(0, n, max(1, n // 10_000), device=self.dev)[:10_000]
        truth, _ = brute.brute_force_knn(x, x[rows], 10, "l2", exclude_ids=rows.int(),
                                         sq_norms=g.sq_norms, device=self.dev)
        recall = brute.recall_at_k(g.nbr_ids[rows], truth, 10)
        torch.cuda.synchronize()
        t_recall = time.perf_counter() - t1
        self.launches = self.ops.launch_counts()
        rate = construct.scanning_rate(stats, n)
        print(f"phase 4: knn-lgd build n={n} d=128 W={cfg.wave}: {t_build:.3f} s, "
              f"{n / t_build:.1f} rows/s, {stats.n_waves} waves, scanning rate {rate:.6f}, "
              f"peak memory {peak / 2**30:.3f} GiB", flush=True)
        print(f"phase 4: graph recall@10 over {rows.numel()} strided rows = {recall:.4f} "
              f"(brute force {t_recall:.3f} s)", flush=True)
        print(f"launches on the main path: {json.dumps(self.launches)}", flush=True)
        inv = graph_lib.graph_invariants_ok(g)
        bad = [k for k, v in inv.items() if not bool(v.all())]
        check(not bad, f"graph invariants violated: {bad}")
        check(g.n_valid == n, f"n_valid {g.n_valid} != {n}")
        check(bool(torch.isfinite(g.nbr_dist).all()), "a row has fewer than k neighbours")
        for name, count in self.launches.items():
            check(count > 0, f"kernel {name} was not launched on the main path")

        # the same build through the plain versions, same data and seeds:
        # where both miss 0.90 the floor is the algorithm's, plain - 0.01
        with self.plain_versions():
            g_p, stats_p, t_plain = run()
        recall_p = brute.recall_at_k(g_p.nbr_ids[rows], truth, 10)
        same = float((g_p.nbr_ids == g.nbr_ids).float().mean())
        floor = min(0.90, recall_p - 0.01)
        print(f"phase 4: plain versions on the card: {t_plain:.3f} s, scanning rate "
              f"{construct.scanning_rate(stats_p, n):.6f}, recall@10 = {recall_p:.4f}, "
              f"{same:.4f} of neighbour ids equal to the kernels' graph; recall floor "
              f"{floor:.4f}", flush=True)
        check(recall >= floor, f"graph recall@10 {recall:.4f} < floor {floor:.4f}")

    def kernel_records(self):
        out = []
        for name, (source, replaces) in KERNELS.items():
            r = self.rec[name]
            out.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": self.launches[name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"], "shape": r["shape"],
            })
        return out


if __name__ == "__main__":
    sys.exit(main())
