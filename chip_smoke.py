#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

needs one NVIDIA card and runs, in order:

1. the card's name and power limit (``nvidia-smi``);
2. builds the three hand-written kernel sources from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together: seven kernels, the fp32,
   bf16 and int8 forms of ``gather_distance`` and ``fused_expand`` and the
   fp32 ``pairwise_distance``) and holds each kernel against its plain
   PyTorch version on the card: at a small shape for each of the five
   metrics and at the main path's shapes, distances to ``rtol=1e-5,
   atol=1e-3`` on Gaussian data and bit for bit on integer-valued data
   (for the bf16 and int8 forms: under l2 and ip, and l1 at bf16); prints
   each kernel's time, its plain version's time, its bound from the bytes
   of its storage type and, for ``pairwise_distance``, ``torch.mm(q, x.T)``
   in IEEE fp32 (the library time) and ``torch.cdist`` as yardsticks.  The
   gather is also held against its plain version, and timed, at a second
   shape, a large candidate count (B=256, C=512, d=256 over 2^18 rows,
   ``bench_gather.large_c_inputs``: exact on integer rows, to the tolerance
   on N(0,1) rows).  At both shapes each timed gather call reads its own
   queries and ids (``bench_gather.timing_sets``), so its rows come from
   device memory and not from the L2 the call before it filled; the replay
   of one set (warm) is printed beside it, and the same timer reads an
   empty kernel launched with the gather's grid, the floor of any gather's
   time;
3. an n=20,000, d=32 integer-valued build with the kernels and the same
   build with the plain versions, from the same injected seeds, at fp32,
   int8 and bf16: every graph array and the counters must be identical;
4. the online LGD build at full width (the knn-lgd config: k=20, l2, W=4096,
   beam 40, 8 seeds, d=128) over n=1,000,000 clustered rows, then graph
   recall@10 over 10,000 strided rows against ``brute_force_knn`` run
   through the pairwise kernel, self-match excluded; then the same build
   through the plain versions on the card, same data and seeds.  The
   kernels' recall must reach 0.90, or, where the plain build misses 0.90
   too (the algorithm's own floor at this wave width), the plain recall
   less 0.01;
5. the same build at ``precision="int8"`` and at ``"bf16"``, on phase 4's
   data and seeds, through the variant kernels: rows/s, scanning rate, peak
   memory and recall@10 over the same rows, which must reach phase 4's
   recall less 0.05 (the reference's own int8 tolerance).  Then 4,096
   held-out queries search phase 4's graph at fp32 and at pq: with
   ``rerank_factor=1000`` ids and distances equal the fp32 search bit for
   bit, and at the default factor the top-k ids overlap by >= 0.9.  Neither
   prunes at this config (C = k + 2k = 60 <= 80 kept), so the pruning factor
   1 is held to an overlap with fp32 and against itself on the CPU: the
   card's PQ codes against the CPU's encoder, and the whole search, run
   again on the CPU with the card's codes, graph and entry points;
6. a ``kernels`` JSON line: each kernel's launches in the build of its own
   precision (phase 4 for fp32, phase 5 for bf16 and int8), its error
   against the plain version, times and bound.

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

RTOL, ATOL = 1e-5, 1e-3
METRICS = ("l2", "ip", "cosine", "l1", "chi2")
EXACT_METRICS = ("l2", "ip", "l1")  # exact fp32 sums on integer-valued data
VARIANTS = ("bf16", "int8")  # the compressed tables of gather and expand
QUERY_SEED, SEARCH_SEED = 17, 19  # phase 5's held-out queries and entry points
# phase 5's pruning PQ search (rerank_factor=1): its top-k overlap with the
# fp32 search (0.8946 in two runs on an H100 80GB HBM3 at 700 W), and its
# agreement with the same search on the CPU, where only last-bit differences
# of fp32 sums and ADC tables may move a near tie; and the share of the
# card's PQ codes that the CPU's encoder gives too (ties only)
PQ_PRUNE_OVERLAP, PQ_CPU_AGREE, PQ_CODES_AGREE = 0.88, 0.99, 0.999

# the kernels, the CUDA sources that replace the TPU kernels, and the
# pallas_call sites with the storage type each form takes
_GATHER, _EXPAND = "src/repro_torch/csrc/gather_dist.cu", "src/repro_torch/csrc/expand.cu"
KERNELS = {
    "gather_distance": (_GATHER, "src/repro/kernels/gather_dist.py:329 (fp32)"),
    "gather_distance.bf16": (_GATHER, "src/repro/kernels/gather_dist.py:329 (bf16 table, x.dtype branch :295-310)"),
    "gather_distance.int8": (_GATHER, "src/repro/kernels/gather_dist.py:329 (int8 table + row_scale, :295-310)"),
    "fused_expand": (_EXPAND, "src/repro/kernels/expand.py:412 (fp32)"),
    "fused_expand.bf16": (_EXPAND, "src/repro/kernels/expand.py:412 (bf16 table, x_eng :367)"),
    "fused_expand.int8": (_EXPAND, "src/repro/kernels/expand.py:412 (int8 table + gathered scale, :368, :396-398)"),
    "pairwise_distance": ("src/repro_torch/csrc/distance.cu", "src/repro/kernels/distance.py:223 (fp32)"),
}


def kernel_name(kernel, precision):
    return kernel if precision == "fp32" else f"{kernel}.{precision}"


def exact_for(metric, precision):
    """Where a kernel equals its plain version bit for bit on integer data."""
    if precision == "fp32":
        return metric in EXACT_METRICS
    return metric in ("l2", "ip") or (metric == "l1" and precision == "bf16")


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
    t0 = time.perf_counter()
    try:
        for phase in (smoke.build_kernels, smoke.phase_kernels, smoke.phase_build_parity,
                      smoke.phase_full, smoke.phase_compressed):
            phase()
            print(f"  [{phase.__name__} done at {time.perf_counter() - t0:.1f} s]", flush=True)
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
        self.launches = {}  # kernel -> launches in the build of its precision
        from repro_torch.kernels import _cuda, ops
        from repro_torch.launch import bench_gather, profile_build

        self._cuda, self.ops, self.profile, self.bench = _cuda, ops, profile_build, bench_gather

    # ------------------------------------------------------------------ utils
    def gen(self, seed):
        return self.torch.Generator(device=self.dev).manual_seed(seed)

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
        from repro_torch.kernels import distance, ref
        from repro_torch.kernels.precision import encode_dataset

        t0 = time.perf_counter()
        for metric in METRICS:
            for integer in (False, True):
                # 16-byte loads at every storage type, and the scalar path
                for d in (80, 70):
                    x = self.data(500, d, 1, integer=integer, metric=metric)
                    q = self.data(33, d, 2, integer=integer, metric=metric)
                    sq = squared_norms(x)
                    idx = torch.randint(-1, 500, (33, 19), generator=self.gen(3), device=self.dev).int()
                    what = f"{metric} d={d} {'int' if integer else 'gauss'}"
                    for precision in ("fp32",) + VARIANTS:
                        enc = encode_dataset(x, precision)
                        exact = integer and exact_for(metric, precision)
                        self.compare(kernel_name("gather_distance", precision),
                                     self.ops.gather_distance(q, x, idx, metric, sq_norms=sq, enc=enc,
                                                              precision=precision),
                                     ref.gather_distance(q, x, idx, metric, sq_norms=sq, enc=enc,
                                                         precision=precision),
                                     exact=exact, what=what)
                        self.check_expand(x, q, sq, metric, integer, B=33, C=23, e=16, H=64, P=4,
                                          steps=3, enc=enc, precision=precision)
                    for xn in ((None, sq) if metric == "l2" else (None,)):
                        self.compare("pairwise_distance",
                                     distance.pairwise_distance(q, x[:130], metric, x_sq_norms=None if xn is None else xn[:130]),
                                     ref.pairwise_distance(q, x[:130], metric, x_sq_norms=None if xn is None else xn[:130]),
                                     exact=integer and metric in EXACT_METRICS,
                                     what=what + (" cached" if xn is not None else ""))
        print(f"phase 2a: small shapes, five metrics, fp32/bf16/int8 tables: kernels agree "
              f"with plain ({time.perf_counter() - t0:.3f} s)", flush=True)

        # main-path shapes (l2, d=128): seed gather B=4096 C=8, expansion
        # B=4096 C=60 e=40 H=2048 P=8, intra-wave tile 4096², brute tile
        d = knn_lgd.D
        xf = build_graph.make_data(knn_lgd.N_ROWS, d, "l2", self.dev)
        xi = self.data(200_000, d, 8, integer=True)
        for x, integer in ((xf, False), (xi, True)):
            sq = squared_norms(x)
            q, idx = self.bench.main_inputs(x)
            sets = None if integer else self.bench.timing_sets("main", x)
            for precision in ("fp32",) + VARIANTS:
                enc = encode_dataset(x, precision)
                what = f"main shape {precision} {'int' if integer else 'clustered'}"
                got = self.ops.gather_distance(q, x, idx, "l2", sq_norms=sq, enc=enc, precision=precision)
                want = ref.gather_distance(q, x, idx, "l2", sq_norms=sq, enc=enc, precision=precision)
                self.compare(kernel_name("gather_distance", precision), got, want,
                             exact=integer, what=what)
                if not integer:
                    self.time_gather(x, sets, precision)
                self.check_expand(x, q, sq, "l2", integer, B=4096, C=60, e=40, H=2048, P=8,
                                  steps=1, timed=not integer, enc=enc, precision=precision)
            del sets
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

        # the gather at a large candidate count (refine's, the serving
        # searches'), where a query's candidates are split over warps
        for integer in (False, True):
            x, q, idx = self.bench.large_c_inputs(self.dev, integer=integer)
            sq = squared_norms(x)
            for precision in ("fp32",) + VARIANTS:
                enc = encode_dataset(x, precision)
                what = f"large C {precision} {'int' if integer else 'gauss'}"
                got = self.ops.gather_distance(q, x, idx, "l2", sq_norms=sq, enc=enc, precision=precision)
                want = ref.gather_distance(q, x, idx, "l2", sq_norms=sq, enc=enc, precision=precision)
                self.compare(kernel_name("gather_distance", precision), got, want,
                             exact=integer, what=what)
                if not integer:
                    self.time_gather(x, self.bench.timing_sets("large_c", x), precision,
                                     prefix="large_c_")
            del x, enc
        print("phase 2b: gather at a large candidate count: kernels agree with plain", flush=True)

    def time_gather(self, x, sets, precision, prefix=""):
        """Time the gather over the query and id ``sets`` of one shape
        (``bench_gather.measure``: kernel cold and warm, empty launch at its
        grid, ``index_select``, plain version, bound) into the record's
        ``prefix`` keys."""
        m = self.bench.measure(x, sets, precision)
        B, C, d = m["B"], m["C"], m["d"]
        keys = ("ms", "warm_ms", "plain_ms", "floor_ms", "index_select_ms", "bound_ms",
                "bound_by")
        rec = {prefix + k: m[k] for k in keys}
        rec[prefix + "shape"] = f"B={B} C={C} d={d}"
        self.rec[kernel_name("gather_distance", precision)].update(rec, library_ms=None)
        print(f"{kernel_name('gather_distance', precision)} B={B} C={C} d={d}: kernel "
              f"{m['ms']:.6f} ms (warm {m['warm_ms']:.6f} ms), plain {m['plain_ms']:.6f} ms, "
              f"empty launch {m['floor_ms']:.6f} "
              f"ms, index_select {m['index_select_ms']:.6f} ms, bound {m['bound_ms']:.6f} ms "
              f"({m['bound_by']})", flush=True)

    def time_pairwise(self, q, x, xn, *, main):
        torch = self.torch
        from repro_torch.kernels import distance, ref

        m, d = q.shape
        n = x.shape[0]
        ms = self.profile.time_ms([lambda: distance.pairwise_distance(q, x, "l2", x_sq_norms=xn)] * 12)
        plain_ms = self.profile.time_ms([lambda: ref.pairwise_distance(q, x, "l2", x_sq_norms=xn)] * 12)
        # the product alone in IEEE fp32 (TF32 is off), and the library's
        # own distance, which takes square roots and reduces its own norms
        mm_ms = self.profile.time_ms([lambda: torch.mm(q, x.T)] * 12)
        cdist_ms = self.profile.time_ms([lambda: torch.cdist(q, x)] * 12)
        b, how = self.profile.bound_ms(4 * (m * d + n * d + n + m * n), 2 * m * n * d)
        print(f"pairwise_distance m={m} n={n} d={d}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"torch.mm {mm_ms:.6f} ms, torch.cdist {cdist_ms:.6f} ms, bound {b:.6f} ms ({how})",
              flush=True)
        if main:
            self.rec["pairwise_distance"].update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=how,
                                                 library_ms=mm_ms, cdist_ms=cdist_ms,
                                                 shape=f"m=n={m} d={d} cached l2")

    def expand_state(self, x, q, sq, metric, B, C, e, H, P, warm, enc, precision):
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
                metric=metric, probes=P, sq_norms=sq, enc=enc, precision=precision)
        return cands(), beam_ids, beam_dist, beam_exp, vis_ids, vis_dist

    def check_expand(self, x, q, sq, metric, integer, *, B, C, e, H, P, steps, enc, precision,
                     timed=False):
        from repro_torch.kernels import expand

        name = kernel_name("fused_expand", precision)
        exact = integer and exact_for(metric, precision)
        state = self.expand_state(x, q, sq, metric, B, C, e, H, P, 2 if H < 1024 else 6,
                                  enc, precision)
        if timed:
            self.time_expand(x, q, sq, state, P, enc, precision)
        for step in range(steps):
            cands, bi, bd, be, vi, vd = state
            kw = dict(metric=metric, sq_norms=sq, enc=enc, precision=precision)
            got = self.ops.expand_step(q, x, cands, bi, bd, be, vi.clone(), vd.clone(),
                                       hash_probes=P, **kw)
            want = expand.expand_reference(q, x, cands, bi, bd, be, vi.clone(), vd.clone(),
                                           probes=P, **kw)
            what = (f"{metric} B={B} C={C} e={e} H={H} step {step} "
                    f"{'int' if integer else 'float'}")
            # the hash ids and comps never depend on distance values
            for i, field in ((3, "vis_ids"), (5, "comps")):
                self.compare(name, got[i], want[i], exact=True, what=f"{what} {field}")
            for i, field in ((1, "beam_dist"), (4, "vis_dist")):
                self.compare(name, got[i], want[i], exact=exact, what=f"{what} {field}")
            # which ids win the beam depends on the distances' last bits
            # where they are not exact (int8 l1/chi2 sums its dequantized
            # elements in another order)
            if integer and (exact or precision == "fp32"):
                for i, field in ((0, "beam_ids"), (2, "beam_exp")):
                    self.compare(name, got[i], want[i], exact=True, what=f"{what} {field}")
            state = (cands.roll(1, dims=1),) + tuple(want[:5])

    def time_expand(self, x, q, sq, state, P, enc, precision):
        from repro_torch.kernels import expand

        name = kernel_name("fused_expand", precision)
        cands, bi, bd, be, vi, vd = state
        kw = dict(metric="l2", sq_norms=sq, enc=enc, precision=precision)
        reps = 12
        # every call gets its own copy of the hash it updates in place
        hashes = [(vi.clone(), vd.clone()) for _ in range(reps)]
        ms = self.profile.time_ms([lambda h=h: self.ops.expand_step(q, x, cands, bi, bd, be, *h,
                                                                  hash_probes=P, **kw)
                                 for h in hashes])
        hashes = [(vi.clone(), vd.clone()) for _ in range(reps)]
        plain_ms = self.profile.time_ms([lambda h=h: expand.expand_reference(
            q, x, cands, bi, bd, be, *h, probes=P, **kw) for h in hashes])
        out = expand.expand_reference(q, x, cands, bi, bd, be, vi.clone(), vd.clone(), probes=P, **kw)
        B, C = cands.shape
        e, d = bi.shape[1], x.shape[1]
        fresh = int(out[5].sum())
        valid = int((cands >= 0).sum())
        inserted = int((out[3] >= 0).sum() - (vi >= 0).sum())
        nbytes = self.profile.expand_bytes(B, C, e, d, P, precision, fresh, valid, inserted)
        b, how = self.profile.bound_ms(nbytes, 2 * d * fresh)
        self.rec[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=how,
                              library_ms=None,
                              shape=f"B={B} C={C} e={e} H={vi.shape[1]} P={P} d={d}")
        print(f"{name} B={B} C={C} e={e} H={vi.shape[1]} P={P} d={d} "
              f"(fresh {fresh}, inserted {inserted}): kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"bound {b:.6f} ms ({how})", flush=True)

    # ---------------------------------------------------------------- phase 3
    @contextlib.contextmanager
    def plain_versions(self):
        """Route the build through the plain versions (on the card)."""
        from repro_torch.kernels import expand, ref

        ops = self.ops
        saved = (ops.pairwise_distance, ops.gather_distance, ops.expand_step)

        def expand_step(*args, hash_probes=8, rerank_keep=0, **kw):
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
        for precision in ("fp32",) + VARIANTS:
            cfg = dataclasses.replace(knn_lgd.full_config(), wave=1024, precision=precision)

            def seed_fn(wave, pos, W, n_valid):
                g = torch.Generator().manual_seed(1000 + wave)
                return torch.randint(0, max(n_valid, 1), (W, cfg.n_seeds), generator=g,
                                     dtype=torch.int32)

            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g, st = construct.build(x, cfg, seed_fn=seed_fn, device=self.dev)
                torch.cuda.synchronize()
                return g, st, time.perf_counter() - t0

            self.ops.reset_launch_counts()
            g_k, st_k, t_k = run()
            counts = self.ops.launch_counts()
            for kernel in ("gather_distance", "fused_expand"):
                name = kernel_name(kernel, precision)
                check(counts[name] > 0, f"n={n} {precision} build launched no {name}")
            with self.plain_versions():
                g_p, st_p, t_p = run()
            check(self.ops.launch_counts() == counts, f"n={n} {precision} plain build launched a kernel")
            a, b = convert.graph_to_numpy(g_k), convert.graph_to_numpy(g_p)
            for name in a:
                check((a[name] == b[name]).all(),
                      f"n={n} {precision} build: field {name} differs, kernels vs plain")
            for name in ("n_comps", "n_inserted_edges"):
                check(int(getattr(st_k, name)) == int(getattr(st_p, name)),
                      f"n={n} {precision} build: {name} differs, kernels vs plain")
            print(f"phase 3: n={n} d={d} integer build, W={cfg.wave}, precision={precision}: graph "
                  f"arrays, n_comps={int(st_k.n_comps)} and edges identical, kernels vs plain "
                  f"(kernels {t_k:.3f} s, plain {t_p:.3f} s)", flush=True)

    # ---------------------------------------------------------------- phase 4
    def build_full(self, cfg):
        """The knn-lgd build over phase 2's rows from the launcher's entry
        point seed: (graph, stats, seconds)."""
        torch = self.torch
        from repro_torch.core import construct
        from repro_torch.launch import build_graph

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, stats = construct.build(self.xf, cfg, generator=self.gen(build_graph.BUILD_SEED),
                                   device=self.dev)
        torch.cuda.synchronize()
        return g, stats, time.perf_counter() - t0

    def counted_build(self, cfg, kernels):
        """The main path at ``cfg``: launch counts zeroed just before the
        build and read just after; every kernel in ``kernels`` must have
        launched.  Returns (graph, stats, seconds, peak bytes)."""
        torch = self.torch

        torch.cuda.reset_peak_memory_stats()
        self.ops.reset_launch_counts()
        g, stats, t_build = self.build_full(cfg)
        peak = torch.cuda.max_memory_allocated()
        counts = self.ops.launch_counts()
        print(f"launches on the {cfg.precision} main path: {json.dumps(counts)}", flush=True)
        for name in kernels:
            self.launches[name] = counts[name]
            check(counts[name] > 0, f"kernel {name} was not launched on the {cfg.precision} main path")
        return g, stats, t_build, peak

    def check_graph(self, g, what):
        torch = self.torch
        from repro_torch.core import graph as graph_lib

        n = self.xf.shape[0]
        inv = graph_lib.graph_invariants_ok(g)
        bad = [k for k, v in inv.items() if not bool(v.all())]
        check(not bad, f"{what}: graph invariants violated: {bad}")
        check(g.n_valid == n, f"{what}: n_valid {g.n_valid} != {n}")
        check(bool(torch.isfinite(g.nbr_dist).all()), f"{what}: a row has fewer than k neighbours")

    def phase_full(self):
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import brute, construct

        x = self.xf  # the launcher's rows, which phase 2 gathered from
        n = x.shape[0]
        cfg = knn_lgd.full_config()
        g, stats, t_build, peak = self.counted_build(
            cfg, ("gather_distance", "fused_expand", "pairwise_distance"))
        t1 = time.perf_counter()
        rows = torch.arange(0, n, max(1, n // 10_000), device=self.dev)[:10_000]
        truth, _ = brute.brute_force_knn(x, x[rows], 10, "l2", exclude_ids=rows.int(),
                                         sq_norms=g.sq_norms, device=self.dev)
        recall = brute.recall_at_k(g.nbr_ids[rows], truth, 10)
        torch.cuda.synchronize()
        t_recall = time.perf_counter() - t1
        rate = construct.scanning_rate(stats, n)
        print(f"phase 4: knn-lgd build n={n} d=128 W={cfg.wave}: {t_build:.3f} s, "
              f"{n / t_build:.1f} rows/s, {stats.n_waves} waves, scanning rate {rate:.6f}, "
              f"peak memory {peak / 2**30:.3f} GiB", flush=True)
        print(f"phase 4: graph recall@10 over {rows.numel()} strided rows = {recall:.4f} "
              f"(brute force {t_recall:.3f} s)", flush=True)
        self.check_graph(g, "fp32 build")

        # the same build through the plain versions, same data and seeds:
        # where both miss 0.90 the floor is the algorithm's, plain - 0.01
        with self.plain_versions():
            g_p, stats_p, t_plain = self.build_full(cfg)
        recall_p = brute.recall_at_k(g_p.nbr_ids[rows], truth, 10)
        same = float((g_p.nbr_ids == g.nbr_ids).float().mean())
        floor = min(0.90, recall_p - 0.01)
        print(f"phase 4: plain versions on the card: {t_plain:.3f} s, scanning rate "
              f"{construct.scanning_rate(stats_p, n):.6f}, recall@10 = {recall_p:.4f}, "
              f"{same:.4f} of neighbour ids equal to the kernels' graph; recall floor "
              f"{floor:.4f}", flush=True)
        check(recall >= floor, f"graph recall@10 {recall:.4f} < floor {floor:.4f}")
        self.g32, self.rows, self.truth, self.recall32 = g, rows, truth, recall

    # ---------------------------------------------------------------- phase 5
    def phase_compressed(self):
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import brute, construct

        n = self.xf.shape[0]
        for precision in ("int8", "bf16"):
            cfg = dataclasses.replace(knn_lgd.full_config(), precision=precision)
            g, stats, t_build, peak = self.counted_build(
                cfg, tuple(kernel_name(k, precision) for k in ("gather_distance", "fused_expand")))
            recall = brute.recall_at_k(g.nbr_ids[self.rows], self.truth, 10)
            same = float((g.nbr_ids == self.g32.nbr_ids).float().mean())
            print(f"phase 5: knn-lgd build n={n} d=128 W={cfg.wave} precision={precision}: "
                  f"{t_build:.3f} s, {n / t_build:.1f} rows/s, scanning rate "
                  f"{construct.scanning_rate(stats, n):.6f}, peak memory {peak / 2**30:.3f} GiB, "
                  f"recall@10 over {self.rows.numel()} strided rows = {recall:.4f} (fp32 "
                  f"{self.recall32:.4f}), {same:.4f} of neighbour ids equal to the fp32 graph",
                  flush=True)
            self.check_graph(g, f"{precision} build")
            check(recall >= self.recall32 - 0.05,
                  f"{precision} recall@10 {recall:.4f} < fp32 {self.recall32:.4f} - 0.05")
            del g
        self.phase_pq_search()

    def phase_pq_search(self):
        """Held-out queries on phase 4's graph: fp32 against pq at three
        re-rank widths, from the same entry points."""
        torch = self.torch
        from repro_torch.configs import knn_lgd
        from repro_torch.core import brute, search
        from repro_torch.data import synthetic
        from repro_torch.kernels.precision import encode_dataset
        from repro_torch.launch import build_graph

        x, g, m = self.xf, self.g32, 4096
        q = synthetic.clustered(self.gen(build_graph.DATA_SEED), m, x.shape[1],
                                sample_generator=self.gen(QUERY_SEED))
        scfg = knn_lgd.full_config().search_config()
        seeds = search.random_seeds(m, scfg.n_seeds, g.n_valid, self.gen(SEARCH_SEED), self.dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encode_dataset(x, "pq")
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        truth, _ = brute.brute_force_knn(x, q, scfg.k, "l2", sq_norms=g.sq_norms, device=self.dev)

        def run(cfg):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = search.search(g, x, q, cfg, seeds=seeds, enc=enc, device=self.dev)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        def overlap(a, b):
            hit = (a.ids[:, :, None] == b.ids[:, None, :]).any(-1)
            return float(hit.float().mean())

        r32, t32 = run(scfg)
        print(f"phase 5: {m} held-out queries on the fp32 graph, fp32 search: {t32:.3f} s, "
              f"recall@{scfg.k} {brute.recall_at_k(r32.ids, truth, scfg.k):.4f}, "
              f"comps/query {float(r32.n_comps.float().mean()):.1f} (pq encode of {x.shape[0]} "
              f"rows {t_enc:.3f} s, M={enc.codes.shape[1]})", flush=True)
        for factor in (1000, scfg.rerank_factor, 1):
            cfg = dataclasses.replace(scfg, precision="pq", rerank_factor=factor)
            rpq, tpq = run(cfg)
            ov = overlap(rpq, r32)
            print(f"phase 5: pq search, rerank_factor={factor} (keeps {factor * scfg.k} of "
                  f"<= {scfg.k + g.rev_capacity} candidates): {tpq:.3f} s, recall@{scfg.k} "
                  f"{brute.recall_at_k(rpq.ids, truth, scfg.k):.4f}, top-{scfg.k} overlap with "
                  f"fp32 {ov:.4f}, comps/query {float(rpq.n_comps.float().mean()):.1f}", flush=True)
            if factor == 1000:
                check(torch.equal(rpq.ids, r32.ids) and torch.equal(rpq.dists, r32.dists),
                      "pq search with rerank_factor=1000 differs from the fp32 search")
            if factor == scfg.rerank_factor:
                check(ov >= 0.9, f"pq search at the default factor: overlap {ov:.4f} < 0.9")
            if factor == 1:
                check(ov >= PQ_PRUNE_OVERLAP,
                      f"pq search at factor 1: overlap {ov:.4f} with fp32 < {PQ_PRUNE_OVERLAP}")
                self.pq_against_cpu(x, g, q, seeds, enc, cfg, rpq)

    def pq_against_cpu(self, x, g, q, seeds, enc, cfg, rpq):
        """The card's PQ codes and its pruning search, held against the CPU."""
        torch = self.torch
        from repro_torch.core import search
        from repro_torch.kernels.precision import pq_encode

        cpu = torch.device("cpu")
        t0 = time.perf_counter()
        x_cpu, enc_cpu = x.to(cpu), enc.to(cpu)
        codes_agree = float((pq_encode(x_cpu, enc_cpu.codebook) == enc_cpu.codes).float().mean())
        t_codes = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = search.search(g, x_cpu, q.to(cpu), cfg, seeds=seeds.to(cpu), enc=enc_cpu, device=cpu)
        t_search = time.perf_counter() - t0
        card_ids = rpq.ids.to(cpu)
        agree = float((card_ids[:, :, None] == r.ids[:, None, :]).any(-1).float().mean())
        rows_equal = float((card_ids == r.ids).all(1).float().mean())
        print(f"phase 5: pq on the CPU ({torch.get_num_threads()} threads): codes of "
              f"{x.shape[0]} rows {codes_agree:.6f} equal to the card's ({t_codes:.3f} s); "
              f"rerank_factor=1 search {t_search:.3f} s, top-{cfg.k} overlap with the card's "
              f"{agree:.6f}, {rows_equal:.4f} of queries with identical ids", flush=True)
        check(codes_agree >= PQ_CODES_AGREE,
              f"pq codes: {codes_agree:.6f} equal to the CPU's < {PQ_CODES_AGREE}")
        check(agree >= PQ_CPU_AGREE,
              f"pq search at factor 1: overlap {agree:.6f} with the CPU's < {PQ_CPU_AGREE}")

    def kernel_records(self):
        out = []
        for name, (source, replaces) in KERNELS.items():
            r = self.rec[name]
            rec = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": self.launches[name], "max_abs_err": r["max_abs_err"],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "cdist_ms": r.get("cdist_ms"), "shape": r["shape"],
            }
            # the gathers: the empty launch and index_select at the main
            # shape, and the large-C shape
            rec.update({k: v for k, v in r.items()
                        if k in ("warm_ms", "floor_ms", "index_select_ms")
                        or k.startswith("large_c_")})
            out.append(rec)
        return out


if __name__ == "__main__":
    sys.exit(main())
