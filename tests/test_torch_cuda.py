"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda``: without a card every test here skips.  The file imports
neither JAX nor the JAX package, so it runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Distances agree to ``rtol=1e-5, atol=1e-3`` on Gaussian data (summation
order differs); on integer-valued data every output of ``fused_expand``,
hash included, is bit-identical.  The bf16 and int8 variants are held
against the compressed plain version the same way: bit for bit on integer
data for l2/ip (and l1 at bf16), to tolerance elsewhere.  ``tile_topk``
copies distances and never computes one, so it equals its plain version bit
for bit on every input: ids and distance bits.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import brute, construct
from repro_torch.kernels import distance, expand, gather_dist, ops, ref
from repro_torch.kernels import precision as precision_lib
from repro_torch.kernels import tile_topk as tile_topk_lib

torch.set_num_threads(2)

METRICS = ["l2", "ip", "cosine", "l1", "chi2"]
EXACT = ["l2", "ip", "l1"]  # exact fp32 sums on integer-valued data
FIELDS = ("beam_ids", "beam_dist", "beam_exp", "vis_ids", "vis_dist", "comps")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _data(shape, seed, metric, integer, dev):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 8, shape) if integer else rng.randn(*shape)
    a = np.abs(a) if metric == "chi2" else a
    return torch.from_numpy(a.astype(np.float32)).to(dev)


@pytest.mark.parametrize("metric", METRICS)
def test_gather_kernel(card, metric):
    x = _data((300, 36), 1, metric, False, card)
    q = x[:9] * 0.5
    idx = torch.from_numpy(np.random.RandomState(2).randint(-1, 300, (9, 21))).int().to(card)
    torch.testing.assert_close(
        gather_dist.gather_distance(q, x, idx, metric), ref.gather_distance(q, x, idx, metric),
        rtol=1e-5, atol=1e-3,
    )


@pytest.mark.parametrize("metric", METRICS + ["l2-cached"])
def test_pairwise_kernel(card, metric):
    cached = metric == "l2-cached"
    metric = metric.removesuffix("-cached")
    q = _data((70, 40), 3, metric, False, card)
    x = _data((130, 40), 4, metric, False, card)
    xn = (x * x).sum(-1) if cached else None
    torch.testing.assert_close(
        distance.pairwise_distance(q, x, metric, x_sq_norms=xn),
        ref.pairwise_distance(q, x, metric, x_sq_norms=xn),
        rtol=1e-5, atol=1e-3,
    )


@pytest.mark.parametrize("metric", EXACT)
@pytest.mark.parametrize("H", [16, 256])
def test_expand_kernel_bit_exact_on_integers(card, metric, H):
    """H=16 forces probe exhaustion and same-slot collisions."""
    B, C, e, n = 7, 20, 12, 60
    rng = np.random.RandomState(5)
    x = _data((n, 8), 6, metric, True, card)
    cands = torch.from_numpy(rng.randint(-1, n, (B, C))).int().to(card)
    beam_ids = torch.full((B, e), -1, dtype=torch.int32, device=card)
    beam_dist = torch.full((B, e), float("inf"), device=card)
    beam_exp = torch.ones((B, e), dtype=torch.bool, device=card)
    vis_ids = torch.full((B, H), -1, dtype=torch.int32, device=card)
    vis_dist = torch.full((B, H), float("inf"), device=card)
    state_k = state_p = (beam_ids, beam_dist, beam_exp, vis_ids, vis_dist)
    for step in range(3):
        got = expand.fused_expand(x[:B], x, cands, *state_k[:3], *(t.clone() for t in state_k[3:]),
                                  metric=metric, probes=4)
        want = expand.expand_reference(x[:B], x, cands, *state_p[:3], *(t.clone() for t in state_p[3:]),
                            metric=metric, probes=4)
        for name, a, b in zip(FIELDS, got, want):
            assert torch.equal(a, b), f"step {step} {name}"
        state_k, state_p = got[:5], want[:5]
        cands = torch.from_numpy(rng.randint(-1, n, (B, C))).int().to(card)


# (H, C, e, P, d): probe exhaustion (H=16) and the auto-sized maximum hash
# (H=65536); one, two and three 64-candidate passes; e from 1 to more than
# C/2; one, one and two probe batches; d=100 (scalar rows for bf16 and int8),
# 128 (the main shape) and 256 (two 16-byte slices per fp32 lane); and H=2
# with d=70, where the probes, the query and every row take scalar loads
EXPAND_SHAPES = [
    (16, 60, 40, 8, 128), (65536, 60, 40, 8, 128), (16, 130, 64, 16, 100),
    (65536, 96, 1, 1, 256), (2048, 130, 1, 8, 256), (16, 96, 64, 1, 100),
    (65536, 130, 40, 16, 128), (2, 60, 40, 8, 70),
]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("H,C,e,P,d", EXPAND_SHAPES)
def test_expand_kernel_shapes_bit_exact(card, precision, H, C, e, P, d):
    """Chained steps on integer data at the shapes the kernel's thread
    mapping must get right: every field equals the plain version bit for
    bit.  B=37 leaves the last CTA part-filled; the first beam is out of
    order (the merge's general path; later beams come out ordered, with
    dedupe holes), and candidates repeat earlier beams' ids (visited), hold
    -1s and a duplicate."""
    B, n = 37, 400
    rng = np.random.RandomState(H + C + e + P + d)
    x = _data((n, d), 9, "l2", True, card)
    q = _data((B, d), 10, "l2", True, card)
    sq = (x * x).sum(-1)
    enc = precision_lib.encode_dataset(x, precision)
    table, scale = (x, None) if precision == "fp32" else (enc.data, enc.scale)
    beam_ids = rng.randint(-1, n, (B, e))
    beam_dist = np.where(beam_ids >= 0, rng.randint(0, 4000, (B, e)), np.inf)
    state_k = state_p = (
        torch.from_numpy(beam_ids).int().to(card),
        torch.from_numpy(beam_dist.astype(np.float32)).to(card),
        torch.from_numpy(rng.rand(B, e) < 0.5).to(card),
        torch.full((B, H), -1, dtype=torch.int32, device=card),
        torch.full((B, H), float("inf"), device=card),
    )
    for step in range(4):
        c = rng.randint(-1, n, (B, C))
        seen = state_p[0].cpu().numpy()
        k = min(C // 3, e)
        c[:, :k] = np.where(rng.rand(B, k) < 0.7, seen[:, :k], c[:, :k])
        c[:, -1] = c[:, 0]
        cands = torch.from_numpy(c).int().to(card)
        got = expand.fused_expand(q, table, cands, *state_k[:3], *(t.clone() for t in state_k[3:]),
                                  metric="l2", probes=P, sq_norms=sq, row_scale=scale)
        want = expand.expand_reference(q, x, cands, *state_p[:3],
                                       *(t.clone() for t in state_p[3:]), metric="l2", probes=P,
                                       sq_norms=sq, enc=enc, precision=precision)
        for name, a, b in zip(FIELDS, got, want):
            assert torch.equal(a, b), f"step {step} {name}"
        state_k, state_p = got[:5], want[:5]


# (m, n, d): ragged everywhere; the main shape; n one column past a multiple
# of the 128-wide tile with d % 8 != 0; d % 4 != 0 (scalar loads and stores);
# the serving recall audit's brute tile; nearest_landmark's chunk
PAIRWISE_SHAPES = [(1000, 777, 100), (4096, 4096, 128), (129, 385, 36), (130, 257, 70),
                   (96, 8192, 128), (4096, 4000, 128)]


@pytest.mark.parametrize("metric", METRICS + ["l2-cached"])
@pytest.mark.parametrize("m,n,d", PAIRWISE_SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_pairwise_kernel_shapes(card, metric, m, n, d, integer):
    """Bit for bit on integer data (l2/ip/l1), within rtol=1e-5, atol=1e-3
    elsewhere, at ragged and full tiles."""
    cached = metric == "l2-cached"
    metric = metric.removesuffix("-cached")
    q = _data((m, d), 11, metric, integer, card)
    x = _data((n, d), 12, metric, integer, card)
    xn = (x * x).sum(-1) if cached else None
    got = distance.pairwise_distance(q, x, metric, x_sq_norms=xn)
    want = ref.pairwise_distance(q, x, metric, x_sq_norms=xn)
    if integer and metric in EXACT:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("metric", METRICS + ["l2-cached"])
@pytest.mark.parametrize("m,n,d", PAIRWISE_SHAPES)
@pytest.mark.parametrize("integer", [True, False])
def test_pairwise_kernel_bf16_operands(card, metric, m, n, d, integer):
    """Two bf16 operands: the SIMT form (l1, chi2, d % 8 != 0) equals the
    fp32 kernel on the widened rows bit for bit (widening is exact), as
    does the tensor-core form (l2, ip at d % 8 == 0) on integer rows; on
    real rows the tensor-core form sums q·x in its own order, within
    WGMMA_RTOL · (‖q‖² + ‖x‖²) of the fp32 kernel.  Both agree with the
    plain version as the fp32 kernel does; cosine normalizes in fp32 and
    takes the fp32 kernel."""
    cached = metric == "l2-cached"
    metric = metric.removesuffix("-cached")
    q = _data((m, d), 11, metric, integer, card).to(torch.bfloat16)
    x = _data((n, d), 12, metric, integer, card).to(torch.bfloat16)
    xn = (x.float() * x.float()).sum(-1) if cached else None
    wgmma = metric != "cosine" and distance.bf16_form(metric, d, True) == "wgmma"
    before = ops.launch_counts()
    got = distance.pairwise_distance(q, x, metric, x_sq_norms=xn)
    after = ops.launch_counts()
    bf16_launches = after["pairwise_distance.bf16"] - before["pairwise_distance.bf16"]
    assert bf16_launches == (0 if metric == "cosine" else 1)
    wgmma_launches = (after["pairwise_distance.bf16_wgmma"]
                      - before["pairwise_distance.bf16_wgmma"])
    assert wgmma_launches == int(wgmma)
    widened = distance.pairwise_distance(q.float(), x.float(), metric, x_sq_norms=xn)
    if wgmma and not integer:
        _assert_within_norms(got, widened, q, x)
    else:
        assert torch.equal(got, widened)
    want = ref.pairwise_distance(q, x, metric, x_sq_norms=xn)
    if integer and metric in EXACT:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


# the tensor-core form on real-valued rows: each distance within this share
# of ‖q‖² + ‖x‖² of the fp32 kernel on the widened rows (the products are
# exact in fp32; only the order and rounding of their sums differ, a few
# fp32 ulps of the terms over d <= 512, against 1e-5 here)
WGMMA_RTOL = 1e-5
WGMMA_SIZES = [1, 63, 65, 129, 4096, 10000]
WGMMA_D = [8, 16, 24, 64, 128, 136, 256, 512]


def _assert_within_norms(got, want, q, x):
    scale = (q.float() ** 2).sum(-1)[:, None] + (x.float() ** 2).sum(-1)[None, :]
    worst = float(((got - want).abs() / scale.clamp_min(1e-30)).max()) if got.numel() else 0.0
    assert worst <= WGMMA_RTOL, worst


def _bf16_rows(shape, seed, integer, dev):
    """bf16 rows: integers in [-15, 15] (every partial sum of a distance is
    then an integer below 2^24 at d <= 512, so no order of the sums moves a
    bit) or N(0, 1) rounded to bf16."""
    rng = np.random.RandomState(seed)
    a = rng.randint(-15, 16, shape) if integer else rng.randn(*shape)
    return torch.from_numpy(a.astype(np.float32)).to(dev).to(torch.bfloat16)


@pytest.mark.parametrize("metric", ["l2-cached", "l2", "ip"])
@pytest.mark.parametrize("m", WGMMA_SIZES)
@pytest.mark.parametrize("d", WGMMA_D)
def test_pairwise_wgmma_form(card, metric, m, d):
    """The tensor-core form at ragged and full tiles, every depth a stage
    ends in zeros or not, n from one column to 10,000: integer rows equal
    the plain version and the fp32 kernel on the widened rows bit for bit;
    real rows stay within WGMMA_RTOL of the fp32 kernel.  Each call counts
    one launch of the tensor-core form."""
    cached = metric == "l2-cached"
    metric = metric.removesuffix("-cached")
    for n in WGMMA_SIZES:
        for integer in (True, False):
            q = _bf16_rows((m, d), 61, integer, card)
            x = _bf16_rows((n, d), 62, integer, card)
            xn = (x.float() ** 2).sum(-1) if cached else None
            before = ops.launch_counts()["pairwise_distance.bf16_wgmma"]
            got = distance.pairwise_distance(q, x, metric, x_sq_norms=xn)
            assert ops.launch_counts()["pairwise_distance.bf16_wgmma"] == before + 1
            widened = distance.pairwise_distance(q.float(), x.float(), metric, x_sq_norms=xn)
            what = f"n={n} {'int' if integer else 'gauss'}"
            if integer:
                assert torch.equal(got, widened), what
                assert torch.equal(got, ref.pairwise_distance(q, x, metric, x_sq_norms=xn)), what
            else:
                _assert_within_norms(got, widened, q, x)


@pytest.mark.parametrize("n", [32768, 32767])
def test_pairwise_wgmma_outputs_past_2_31(card, n):
    """m·n past 2^31 outputs (64-bit offsets), with 16-byte output rows
    (TMA stores) and without (8-byte stores): rows at the start, the middle
    and the end equal the plain version bit for bit on integer rows."""
    m, d = 66_000, 8
    assert m * n > 2 ** 31
    q, x = _bf16_rows((m, d), 63, True, card), _bf16_rows((n, d), 64, True, card)
    for metric in ("l2", "ip"):
        before = ops.launch_counts()["pairwise_distance.bf16_wgmma"]
        got = distance.pairwise_distance(q, x, metric)
        assert ops.launch_counts()["pairwise_distance.bf16_wgmma"] == before + 1
        for lo in (0, m // 2, m - 64):
            want = ref.pairwise_distance(q[lo:lo + 64], x, metric)
            assert torch.equal(got[lo:lo + 64], want), (metric, lo)
        del got


def test_bf16_data_build_kernels_match_plain(card, monkeypatch):
    """A data_bf16 build on integer rows: the bf16 table and pairwise
    kernels launch, and the graph equals the plain versions' bit for bit."""
    x = _data((3000, 16), 7, "l2", True, card)
    cfg = construct.BuildConfig(k=10, wave=256, beam=24, n_seeds=4, max_iters=30,
                                data_bf16=True)

    def seed_fn(wave, pos, W, n_valid):
        g = torch.Generator().manual_seed(wave)
        return torch.randint(0, max(n_valid, 1), (W, cfg.n_seeds), generator=g)

    ops.reset_launch_counts()
    g_k, st_k = construct.build(x, cfg, seed_fn=seed_fn, device=card)
    counts = ops.launch_counts()
    for name in ("gather_distance.bf16", "fused_expand.bf16", "pairwise_distance.bf16"):
        assert counts[name] > 0, counts
    _route_plain(monkeypatch)
    g_p, st_p = construct.build(x, cfg, seed_fn=seed_fn, device=card)
    for name in ("nbr_ids", "nbr_dist", "nbr_lam", "rev_ids", "rev_lam", "rev_ptr", "alive"):
        assert torch.equal(getattr(g_k, name), getattr(g_p, name)), name
    assert int(st_k.n_comps) == int(st_p.n_comps)


def test_build_kernels_match_plain_and_count_launches(card, monkeypatch):
    """A small integer build: identical graphs through the kernels and through
    the plain versions; every kernel launched."""
    x = _data((3000, 16), 7, "l2", True, card)
    cfg = construct.BuildConfig(k=10, wave=256, beam=24, n_seeds=4, max_iters=30)
    fp32_kernels = ("gather_distance", "fused_expand", "pairwise_distance")

    def seed_fn(wave, pos, W, n_valid):
        g = torch.Generator().manual_seed(wave)
        return torch.randint(0, max(n_valid, 1), (W, cfg.n_seeds), generator=g)

    ops.reset_launch_counts()
    g_k, st_k = construct.build(x, cfg, seed_fn=seed_fn, device=card)
    brute.brute_force_knn(x, x[:50], 10, device=card)
    counts = ops.launch_counts()
    assert all(counts[name] > 0 for name in fp32_kernels), counts
    # one running top-k a brute tile: the exact seed graph's one tile and the
    # 3,000 rows' one tile
    assert counts["tile_topk"] == 2, counts
    _route_plain(monkeypatch)
    g_p, st_p = construct.build(x, cfg, seed_fn=seed_fn, device=card)
    for name in ("nbr_ids", "nbr_dist", "nbr_lam", "rev_ids", "rev_lam", "rev_ptr", "alive"):
        assert torch.equal(getattr(g_k, name), getattr(g_p, name)), name
    assert int(st_k.n_comps) == int(st_p.n_comps)
    assert ops.launch_counts() == counts  # the plain build launched nothing


def _route_plain(monkeypatch):
    """Send ``ops`` to the plain versions for the rest of the test."""
    def expand_step(*a, hash_probes=8, rerank_keep=0, **kw):
        return expand.expand_reference(*a, probes=hash_probes, **kw)

    monkeypatch.setattr(ops, "pairwise_distance", ref.pairwise_distance)
    monkeypatch.setattr(ops, "gather_distance", ref.gather_distance)
    monkeypatch.setattr(ops, "expand_step", expand_step)
    monkeypatch.setattr(ops, "tile_topk", ref.tile_topk)


def _exact(metric, precision):
    return metric in ("ip", "l2") or (metric == "l1" and precision == "bf16")


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("integer", [False, True])
def test_gather_kernel_variants(card, metric, precision, integer):
    """d=64 takes 16-byte loads at both widths, d=36 the scalar path for
    int8 (and 16-byte bf16 loads only where d % 8 == 0)."""
    for d in (64, 36):
        x = _data((300, d), 1, metric, integer, card)
        q = _data((9, d), 2, metric, integer, card)
        sq = (x * x).sum(-1)
        enc = precision_lib.encode_dataset(x, precision)
        idx = torch.from_numpy(np.random.RandomState(2).randint(-1, 300, (9, 21))).int().to(card)
        before = ops.launch_counts()[f"gather_distance.{precision}"]
        got = gather_dist.gather_distance(q, enc.data, idx, metric, sq_norms=sq, row_scale=enc.scale)
        want = ref.gather_distance(q, x, idx, metric, sq_norms=sq, enc=enc, precision=precision)
        assert ops.launch_counts()[f"gather_distance.{precision}"] == before + 1
        if integer and _exact(metric, precision):
            assert torch.equal(got, want), f"d={d}"
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


# (B, C, d): C from one row to more than one chunk per warp; d = 36 and 70
# (scalar rows at bf16/int8, and at every type for 70), 64, 128 and 256
# (16-byte rows, one or two slices per lane); B not a multiple of the CTA's
# eight warps.  (300, 700, 128) splits each query's candidates over warps in
# spans of several chunks, the last one ragged; (4500, 20, 64) gives more
# queries than the card holds warps, so one warp walks all its chunks.
GATHER_SHAPES = [
    (1, 1, 36), (5, 7, 64), (37, 8, 128), (1, 9, 70), (5, 33, 256), (37, 512, 128),
    (5, 512, 36), (37, 33, 70), (1, 512, 256), (300, 700, 128), (4500, 20, 64),
]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("B,C,d", GATHER_SHAPES)
def test_gather_kernel_shapes(card, precision, B, C, d):
    """Every metric on integer and Gaussian rows at the shapes the kernel's
    thread mapping must get right: bit for bit where the sums are exact,
    within rtol=1e-5, atol=1e-3 elsewhere.  The first query's ids are all
    -1 and the second's repeat one id; the rest mix -1s into uniform ids."""
    n = 400
    rng = np.random.RandomState(B + C + d)
    ids = rng.randint(-1, n, (B, C))
    ids[0] = -1
    if B > 1:
        ids[1] = ids[1, 0] if ids[1, 0] >= 0 else 3
    idx = torch.from_numpy(ids).int().to(card)
    for metric in METRICS:
        for integer in (True, False):
            x = _data((n, d), 13, metric, integer, card)
            q = _data((B, d), 14, metric, integer, card)
            sq = (x * x).sum(-1)
            enc = precision_lib.encode_dataset(x, precision)
            table, scale = (x, None) if precision == "fp32" else (enc.data, enc.scale)
            got = gather_dist.gather_distance(q, table, idx, metric, sq_norms=sq, row_scale=scale)
            want = ref.gather_distance(q, x, idx, metric, sq_norms=sq, enc=enc,
                                       precision=precision)
            what = f"{metric} {'int' if integer else 'gauss'}"
            assert torch.equal(torch.isinf(got), idx < 0), what
            exact = metric in EXACT if precision == "fp32" else _exact(metric, precision)
            if integer and exact:
                assert torch.equal(got, want), what
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3, msg=what)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("d", [7264, 7268, 12288, "max"])
def test_gather_kernel_wide_queries(card, precision, d):
    """Eight queries fill a CTA's shared memory up to d = 7,264; wider, a
    CTA holds fewer warps, down to one at ``max_width``.  Integer rows, bit
    for bit under l2 and ip; B not a multiple of the warps per CTA."""
    d = gather_dist.max_width(card) if d == "max" else d
    B, C, n = 11, 9, 40
    idx = torch.from_numpy(np.random.RandomState(d).randint(-1, n, (B, C))).int().to(card)
    for metric in ("l2", "ip"):
        x = _data((n, d), 18, metric, True, card)
        q = _data((B, d), 19, metric, True, card)
        sq = (x * x).sum(-1)
        enc = precision_lib.encode_dataset(x, precision)
        table, scale = (x, None) if precision == "fp32" else (enc.data, enc.scale)
        got = gather_dist.gather_distance(q, table, idx, metric, sq_norms=sq, row_scale=scale)
        want = ref.gather_distance(q, x, idx, metric, sq_norms=sq, enc=enc, precision=precision)
        assert torch.equal(got, want), metric


def test_gather_kernel_refuses_wider_queries(card):
    d = gather_dist.max_width(card) + 4
    x = _data((10, d), 20, "l2", True, card)
    idx = torch.zeros((1, 3), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="wider than"):
        gather_dist.gather_distance(x[:1], x, idx)


@pytest.mark.parametrize("B,C,d", [(4096, 8, 128), (256, 512, 256)])
def test_gather_floor_is_not_a_gather_launch(card, B, C, d):
    """The empty kernel at the gather's grid launches without error and is
    not counted as a gather launch."""
    x = _data((500, d), 15, "l2", False, card)
    idx = torch.from_numpy(np.random.RandomState(16).randint(0, 500, (B, C))).int().to(card)
    before = ops.launch_counts()
    gather_dist.gather_floor(_data((B, d), 17, "l2", False, card), x, idx)
    torch.cuda.synchronize()
    assert ops.launch_counts() == before


@pytest.mark.parametrize(
    "metric,precision", [("l2", "bf16"), ("l2", "int8"), ("ip", "int8"), ("l1", "bf16")])
def test_expand_kernel_variants_bit_exact_on_integers(card, metric, precision):
    B, C, e, n, H = 7, 20, 12, 60, 16
    rng = np.random.RandomState(5)
    x = _data((n, 32), 6, metric, True, card)
    sq = (x * x).sum(-1)
    enc = precision_lib.encode_dataset(x, precision)
    cands = torch.from_numpy(rng.randint(-1, n, (B, C))).int().to(card)
    state_k = state_p = (
        torch.full((B, e), -1, dtype=torch.int32, device=card),
        torch.full((B, e), float("inf"), device=card),
        torch.ones((B, e), dtype=torch.bool, device=card),
        torch.full((B, H), -1, dtype=torch.int32, device=card),
        torch.full((B, H), float("inf"), device=card),
    )
    kw = dict(metric=metric, probes=4, sq_norms=sq)
    for step in range(3):
        got = expand.fused_expand(x[:B], enc.data, cands, *state_k[:3],
                                  *(t.clone() for t in state_k[3:]), row_scale=enc.scale, **kw)
        want = expand.expand_reference(x[:B], x, cands, *state_p[:3],
                                       *(t.clone() for t in state_p[3:]), enc=enc,
                                       precision=precision, **kw)
        for name, a, b in zip(FIELDS, got, want):
            assert torch.equal(a, b), f"step {step} {name}"
        state_k, state_p = got[:5], want[:5]
        cands = torch.from_numpy(rng.randint(-1, n, (B, C))).int().to(card)


@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_compressed_build_kernels_match_plain(card, monkeypatch, precision):
    """A small integer build at bf16/int8: identical graphs through the
    variant kernels and through the plain versions."""
    x = _data((3000, 16), 7, "l2", True, card)
    cfg = construct.BuildConfig(k=10, wave=256, beam=24, n_seeds=4, max_iters=30,
                                precision=precision)

    def seed_fn(wave, pos, W, n_valid):
        g = torch.Generator().manual_seed(wave)
        return torch.randint(0, max(n_valid, 1), (W, cfg.n_seeds), generator=g)

    ops.reset_launch_counts()
    g_k, st_k = construct.build(x, cfg, seed_fn=seed_fn, device=card)
    counts = ops.launch_counts()
    for name in ("gather_distance", "fused_expand"):
        assert counts[f"{name}.{precision}"] > 0 and counts[name] == 0, counts
    _route_plain(monkeypatch)
    g_p, st_p = construct.build(x, cfg, seed_fn=seed_fn, device=card)
    for name in ("nbr_ids", "nbr_dist", "nbr_lam", "rev_ids", "rev_lam", "rev_ptr", "alive"):
        assert torch.equal(getattr(g_k, name), getattr(g_p, name)), name
    assert int(st_k.n_comps) == int(st_p.n_comps)
    assert ops.launch_counts() == counts


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("B", [1, 37, 64])
@pytest.mark.parametrize("integer", [True, False])
def test_serving_shapes(card, precision, B, integer):
    """The serving searches' shapes at d=128: the coarse seed gather (C=44:
    T + T·M + p = 4 + 32 + 8) and chained expansions at beam 64 (C=60, e=64,
    H=auto_hash_slots(64, 60)=2048, P=8).  Bit for bit on integer rows;
    Gaussian distances within rtol=1e-5, atol=1e-3, hash ids and comps
    exact."""
    n, d, C, e, H, P = 2000, 128, 60, 64, 2048, 8
    rng = np.random.RandomState(B)
    x = _data((n, d), 21, "l2", integer, card)
    q = _data((B, d), 22, "l2", integer, card)
    sq = (x * x).sum(-1)
    enc = precision_lib.encode_dataset(x, precision)
    table, scale = (x, None) if precision == "fp32" else (enc.data, enc.scale)

    def close(a, b, what):
        if integer:
            assert torch.equal(a, b), what
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-3, msg=what)

    idx = torch.from_numpy(rng.randint(-1, n, (B, 44))).int().to(card)
    close(gather_dist.gather_distance(q, table, idx, "l2", sq_norms=sq, row_scale=scale),
          ref.gather_distance(q, x, idx, "l2", sq_norms=sq, enc=enc, precision=precision),
          "gather")
    state = (
        torch.full((B, e), -1, dtype=torch.int32, device=card),
        torch.full((B, e), float("inf"), device=card),
        torch.ones((B, e), dtype=torch.bool, device=card),
        torch.full((B, H), -1, dtype=torch.int32, device=card),
        torch.full((B, H), float("inf"), device=card),
    )
    for step in range(3):
        c = rng.randint(-1, n, (B, C))
        c[:, :20] = np.where(rng.rand(B, 20) < 0.5, state[0].cpu().numpy()[:, :20], c[:, :20])
        cands = torch.from_numpy(c).int().to(card)
        got = expand.fused_expand(q, table, cands, *state[:3], *(t.clone() for t in state[3:]),
                                  metric="l2", probes=P, sq_norms=sq, row_scale=scale)
        want = expand.expand_reference(q, x, cands, *state[:3], *(t.clone() for t in state[3:]),
                                       metric="l2", probes=P, sq_norms=sq, enc=enc,
                                       precision=precision)
        for name, a, b in zip(FIELDS, got, want):
            if name in ("vis_ids", "comps"):
                assert torch.equal(a, b), f"step {step} {name}"
            elif integer or name in ("beam_dist", "vis_dist"):
                close(a.float(), b.float(), f"step {step} {name}")
        state = want[:5]


# ---------------------------------------------- the divide-and-conquer slice


@pytest.mark.parametrize("integer", [True, False])
def test_merge_proposals_shape(card, integer, monkeypatch):
    """The second-hop gather at the merge's shape (C = HOP_TOP·k = 400,
    d=128), in row chunks smaller than the side: bit for bit on integer
    rows, to tolerance on Gaussian rows; one launch per chunk."""
    from repro_torch.core.merge import HOP_TOP

    n, d, k = 4000, 128, 20
    rng = np.random.RandomState(31)
    x = _data((n, d), 32, "l2", integer, card)
    q = _data((2500, d), 33, "l2", integer, card)
    hits = torch.from_numpy(rng.randint(-1, n, (2500, k))).int().to(card)
    t_nbr = torch.from_numpy(rng.randint(-1, n, (n, k))).int().to(card)
    alive = torch.from_numpy(rng.rand(n) > 0.05).to(card)
    sq = (x * x).sum(-1)
    monkeypatch.setattr(ops, "MERGE_PROPOSAL_ROWS", 1024)
    ops.reset_launch_counts()
    got = ops.merge_proposals(q, x, hits, t_nbr, alive, sq_norms=sq, hop_top=HOP_TOP)
    assert ops.launch_counts()["gather_distance"] == 3
    assert got[0].shape == (2500, HOP_TOP * k)
    want = ref.gather_distance(q, x, got[0], "l2", sq_norms=sq)
    if integer:
        assert torch.equal(got[1], want)
    else:
        torch.testing.assert_close(got[1], want, rtol=1e-5, atol=1e-3)


def _graph_fields_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y, name


def test_parallel_build_kernels_match_plain(card, monkeypatch):
    """build_parallel (3 blocks, one refine round) on integer rows: the
    same graph and counters through the kernels and the plain versions,
    every kernel launched."""
    from repro_torch.core.draws import TorchDraws

    x = _data((3000, 16), 34, "l2", True, card)
    cfg = construct.BuildConfig(k=10, wave=256, beam=24, n_seeds=4, max_iters=30)
    ops.reset_launch_counts()
    g_k, st_k = construct.build_parallel(x, cfg, TorchDraws(5), shards=3, search_chunk=256,
                                         device=card)
    counts = ops.launch_counts()
    assert all(counts[n] > 0 for n in ("gather_distance", "fused_expand", "pairwise_distance"))
    _route_plain(monkeypatch)
    g_p, st_p = construct.build_parallel(x, cfg, TorchDraws(5), shards=3, search_chunk=256,
                                         device=card)
    _graph_fields_equal(g_k, g_p)
    assert int(st_k.n_comps) == int(st_p.n_comps)
    assert ops.launch_counts() == counts


def test_router_kernels_match_plain(card, monkeypatch):
    """A 3-shard router's churn (add, remove, compact), graph and brute
    retrieval and merge_shards, through the kernels and the plain
    versions: the same shards, tables and answers."""
    from repro_torch.core.draws import TorchDraws
    from repro_torch.index import ShardedIndex

    x = _data((3000, 16), 35, "l2", True, card)
    new = _data((200, 16), 36, "l2", True, card)
    q = _data((8, 16), 37, "l2", True, card)
    cfg = construct.BuildConfig(k=10, wave=256, beam=24, n_seeds=4, max_iters=30)

    def run():
        r = ShardedIndex.build(x, 3, cfg, draws=TorchDraws(6), device=card)
        r.add(new, seed_fn=lambda w, p, W, nv: TorchDraws(7 + w).randint((W, 4), nv, card))
        r.remove(np.arange(0, 3200, 11))
        r.compact()
        answers = [r.retrieve(q, 10, beam=32, draws=TorchDraws(8)), r.retrieve(q, 10, brute=True)]
        r.merge_shards(draws=TorchDraws(9))
        return r, answers + [r.retrieve(q, 10, beam=32, draws=TorchDraws(10))]

    ops.reset_launch_counts()
    r_k, a_k = run()
    counts = ops.launch_counts()
    assert all(counts[n] > 0 for n in ("gather_distance", "fused_expand", "pairwise_distance"))
    _route_plain(monkeypatch)
    r_p, a_p = run()
    _graph_fields_equal(r_k.shards[0].graph, r_p.shards[0].graph)
    assert np.array_equal(r_k.gids[0], r_p.gids[0])
    for (i_k, s_k), (i_p, s_p) in zip(a_k, a_p):
        assert np.array_equal(i_k, i_p) and np.array_equal(s_k, s_p)


def test_nndescent_build_kernel_matches_plain(card, monkeypatch):
    """NN-Descent's random initial lists (the gather at B = n, C = k + 4)
    and its join rounds give the same graph through the kernel."""
    from repro_torch.core import nndescent
    from repro_torch.core.draws import TorchDraws

    x = _data((2000, 16), 38, "l2", True, card)
    cfg = nndescent.NNDescentConfig(k=10, max_iters=3, node_chunk=512)
    ops.reset_launch_counts()
    g_k, st_k = nndescent.build(x, cfg, TorchDraws(11), device=card)
    assert ops.launch_counts()["gather_distance"] == 1
    _route_plain(monkeypatch)
    g_p, st_p = nndescent.build(x, cfg, TorchDraws(11), device=card)
    _graph_fields_equal(g_k, g_p)
    assert st_k == st_p


def test_mind_index_kernels_match_plain(card, monkeypatch):
    """The recommender serving path on integer-valued items under ip: an
    index build, one request's retrieval (4 interests, top-20 at beam 48),
    churn and the brute answer, through the kernels and the plain versions:
    the same graph and answers."""
    from repro_torch.serve import retrieval

    items = _data((3000, 16), 38, "ip", True, card) - 4.0
    q = _data((4, 16), 39, "ip", True, card) - 4.0
    new = _data((100, 16), 40, "ip", True, card) - 4.0

    def run():
        idx = retrieval.build_index(items, k=16, metric="ip", wave=512, capacity=3200,
                                    generator=torch.Generator(device=card).manual_seed(1),
                                    device=card)
        out = [retrieval.retrieve(idx, q, 20, beam=48), retrieval.retrieve_brute(idx, q, 20)]
        idx = retrieval.remove_items(retrieval.add_items(idx, new), torch.arange(50, device=card))
        return idx, out + [retrieval.retrieve(idx, q, 20, beam=48)]

    ops.reset_launch_counts()
    i_k, a_k = run()
    counts = ops.launch_counts()
    assert all(counts[n] > 0 for n in ("gather_distance", "fused_expand", "pairwise_distance"))
    _route_plain(monkeypatch)
    i_p, a_p = run()
    _graph_fields_equal(i_k.graph, i_p.graph)
    for (ids_k, s_k), (ids_p, s_p) in zip(a_k, a_p):
        assert torch.equal(ids_k, ids_p) and torch.equal(s_k, s_p)
    assert not torch.isin(a_k[2][0], torch.arange(50, device=card)).any()


@pytest.mark.parametrize("arch", ["deepfm", "xdeepfm", "bst", "mind"])
def test_recsys_scores_on_the_card_match_the_cpu(card, arch):
    """Each arch's serve and retrieval scorers at ``smoke_config()`` on the
    card against the same parameters and inputs on the CPU, to rtol 1e-5,
    atol 1e-6 (fp32 sums in another order)."""
    from repro_torch import configs
    from repro_torch.data import recsys_data
    from repro_torch.models import recsys

    cfg = configs.get(arch).smoke_config()
    g = torch.Generator().manual_seed(3)
    params = recsys.init_params(g, cfg)
    if arch in ("deepfm", "xdeepfm"):
        batch = recsys_data.ctr_batch(g, 300, cfg.n_sparse, cfg.vocab_per_field)
        rb = {"dense": batch["dense"][:1], "sparse": batch["sparse"][:1],
              "cand": recsys_data.zipf_ids(g, (700,), cfg.vocab_per_field)}

        def score(p, b):
            return recsys.ctr_retrieval_scores(p, b, cfg, chunk=256)
    else:
        batch = recsys_data.behavior_batch(g, 300, cfg.seq_len, cfg.vocab_per_field)
        if arch == "bst":
            rb = {"hist": batch["hist"][:1], "cand": recsys_data.zipf_ids(g, (700,), cfg.vocab_per_field)}

            def score(p, b):
                return recsys.bst_retrieval_scores(p, b, cfg, chunk=256)
        else:
            rb = recsys_data.retrieval_batch(g, 700, cfg.embed_dim, seq_len=cfg.seq_len,
                                             vocab=cfg.vocab_per_field)

            def score(p, b):
                return recsys.retrieval_scores(p, b["hist"], b["candidates"], cfg)

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(card) for k, v in tree.items()}

    for fn, b in ((lambda p, b: recsys.serve_scores(p, b, cfg, chunk=128), batch), (score, rb)):
        got = fn(to(params), to(b)).cpu()
        want = fn(params, b)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [((128, 1, 4, 256), (128, 1, 256, 4096)),
                                   ((2, 1, 8, 1024, 256), (2, 1, 8, 256, 512)),
                                   ((1, 8, 3, 7, 128), (1, 8, 3, 128, 9))])
def test_lm_bf16_product_with_fp32_output_matches_the_widened_one(card, monkeypatch, shape):
    """``attention.matmul_f32`` on bf16 operands on the card (cuBLAS with
    fp32 output) against the same product of the operands widened to fp32:
    one function, sums in another order (rtol 1e-5, 1e-6 of the largest)."""
    from repro_torch.models import attention

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=card).manual_seed(6)
    a, b = (torch.randn(s, generator=g, device=card).bfloat16() for s in shape)
    got = attention.matmul_f32(a, b)
    want = torch.matmul(a.float(), b.float())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


LM_ARCHS = ["mixtral-8x7b", "arctic-480b", "stablelm-1.6b", "qwen2.5-3b", "gemma3-1b"]


def _lm_close(got, want, rel):
    """Within ``rel`` of the largest element (and 1e-5 of each, at fp32)."""
    got, want = got.float().cpu(), want.float()
    torch.testing.assert_close(got, want, rtol=1e-5 if rel < 1e-3 else 0,
                               atol=rel * float(want.abs().max()))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_and_decode_on_the_card_match_the_cpu(card, monkeypatch, arch, compute):
    """Each LM's ``smoke_config()`` on the card against the same parameters
    and tokens on the CPU: forward logits, prefill, and 40 steps of
    ``decode_step`` and ``decode_step_split`` (past gemma3's 16-slot ring
    wrap and mixtral's 32).  fp32 compute (TF32 off, fp32 decode caches):
    rtol 1e-5 and 1e-5 of the largest logit (fp32 sums in another order,
    through 2-3 layers and, in decode, every earlier step's K/V; a bf16
    cache would round a K/V element the other way now and then and move
    the logits by up to 4e-5 of the largest, as a first card run showed);
    prefill's bf16 cache within one bf16 rounding.  The configs' bf16:
    2^-5 of the largest (bf16 products rounded in another order; against
    the reference on the CPU they differ by at most 0.68%)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(configs.get(arch).smoke_config(), compute_dtype=compute)
    fp32 = compute == "float32"
    rel = 1e-5 if fp32 else 2.0 ** -5
    cache_dtype = torch.float32 if fp32 else torch.bfloat16
    params = tfm.init_params(torch.Generator().manual_seed(4), cfg)
    on_card = {k: v.to(card) for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        _lm_close(tfm.forward(on_card, toks.to(card), cfg)[0], tfm.forward(params, toks, cfg)[0],
                  rel)
        lg, cg = tfm.prefill(on_card, toks.to(card), cfg)
        lc, cc = tfm.prefill(params, toks, cfg)
        _lm_close(lg, lc, rel)
        _lm_close(cg["k"], cc["k"], max(rel, 2.0 ** -7))
        for split in (False, True):
            init = tfm.init_split_cache if split else tfm.init_cache
            step = tfm.decode_step_split if split else tfm.decode_step
            c_card = init(cfg, 2, 72, cache_dtype, device=card)
            c_cpu = init(cfg, 2, 72, cache_dtype, device="cpu")
            for t in range(40):
                lg, c_card = step(on_card, c_card, toks[:, t].to(card), cfg)
                lc, c_cpu = step(params, c_cpu, toks[:, t], cfg)
                assert torch.isfinite(lg).all()
                _lm_close(lg, lc, rel)


# ------------------------------------------------ atom positions: d = 1, 2, 3

# d below one 16-byte vector: every kernel takes its scalar loads, a row's
# group has fewer lanes than a warp, and one k-slice of the pairwise tile is
# mostly zero fill
NARROW_D = [1, 2, 3]


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("d", NARROW_D)
@pytest.mark.parametrize("B,C", [(1, 1), (37, 8), (300, 44), (5, 512)])
def test_gather_kernel_narrow_rows(card, precision, d, B, C):
    """Every metric at d < 4, bit for bit on integer rows where the sums
    are exact, within rtol=1e-5, atol=1e-3 elsewhere; ids < 0 give +inf."""
    n = 400
    rng = np.random.RandomState(B + C + d)
    idx = torch.from_numpy(rng.randint(-1, n, (B, C))).int().to(card)
    for metric in METRICS:
        for integer in (True, False):
            x = _data((n, d), 41, metric, integer, card)
            q = _data((B, d), 42, metric, integer, card)
            sq = (x * x).sum(-1)
            enc = precision_lib.encode_dataset(x, precision)
            table, scale = (x, None) if precision == "fp32" else (enc.data, enc.scale)
            got = gather_dist.gather_distance(q, table, idx, metric, sq_norms=sq, row_scale=scale)
            want = ref.gather_distance(q, x, idx, metric, sq_norms=sq, enc=enc,
                                       precision=precision)
            what = f"{metric} {'int' if integer else 'gauss'}"
            assert torch.equal(torch.isinf(got), idx < 0), what
            exact = metric in EXACT if precision == "fp32" else _exact(metric, precision)
            if integer and exact:
                assert torch.equal(got, want), what
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3, msg=what)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("d", NARROW_D)
@pytest.mark.parametrize("H,C,e,P", [(16, 24, 8, 4), (2048, 24, 16, 8), (2048, 130, 64, 8)])
def test_expand_kernel_narrow_rows_bit_exact(card, precision, d, H, C, e, P):
    """Chained expansions on integer rows at d < 4 (the atom build's C =
    k + 2k = 24, e=16 at H=2048; probe exhaustion at H=16; three candidate
    passes at C=130): every field equals the plain version bit for bit."""
    B, n = 37, 400
    rng = np.random.RandomState(H + C + e + d)
    x = _data((n, d), 43, "l2", True, card)
    q = _data((B, d), 44, "l2", True, card)
    sq = (x * x).sum(-1)
    enc = precision_lib.encode_dataset(x, precision)
    table, scale = (x, None) if precision == "fp32" else (enc.data, enc.scale)
    state_k = state_p = (
        torch.full((B, e), -1, dtype=torch.int32, device=card),
        torch.full((B, e), float("inf"), device=card),
        torch.ones((B, e), dtype=torch.bool, device=card),
        torch.full((B, H), -1, dtype=torch.int32, device=card),
        torch.full((B, H), float("inf"), device=card),
    )
    for step in range(4):
        c = rng.randint(-1, n, (B, C))
        k = min(C // 3, e)
        c[:, :k] = np.where(rng.rand(B, k) < 0.7, state_p[0].cpu().numpy()[:, :k], c[:, :k])
        cands = torch.from_numpy(c).int().to(card)
        got = expand.fused_expand(q, table, cands, *state_k[:3], *(t.clone() for t in state_k[3:]),
                                  metric="l2", probes=P, sq_norms=sq, row_scale=scale)
        want = expand.expand_reference(q, x, cands, *state_p[:3],
                                       *(t.clone() for t in state_p[3:]), metric="l2", probes=P,
                                       sq_norms=sq, enc=enc, precision=precision)
        for name, a, b in zip(FIELDS, got, want):
            assert torch.equal(a, b), f"step {step} {name}"
        state_k, state_p = got[:5], want[:5]


@pytest.mark.parametrize("metric", METRICS + ["l2-cached"])
@pytest.mark.parametrize("d", NARROW_D)
@pytest.mark.parametrize("m,n", [(1, 1), (129, 385), (1024, 1024), (96, 8192)])
def test_pairwise_kernel_narrow_rows(card, metric, d, m, n):
    """The tile at d < 4, fp32 and bf16 operands: bit for bit on integer
    rows (l2/ip/l1), within rtol=1e-5, atol=1e-3 on Gaussian rows."""
    cached = metric == "l2-cached"
    metric = metric.removesuffix("-cached")
    for integer in (True, False):
        q = _data((m, d), 45, metric, integer, card)
        x = _data((n, d), 46, metric, integer, card)
        for dt in (torch.float32, torch.bfloat16):
            qq, xx = q.to(dt), x.to(dt)
            xn = (xx.float() * xx.float()).sum(-1) if cached else None
            got = distance.pairwise_distance(qq, xx, metric, x_sq_norms=xn)
            want = ref.pairwise_distance(qq, xx, metric, x_sq_norms=xn)
            what = f"{metric} {dt} {'int' if integer else 'gauss'}"
            if integer and metric in EXACT:
                assert torch.equal(got, want), what
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3, msg=what)


def test_atom_build_kernels_match_plain(card, monkeypatch):
    """The atom graph's build (d=3, k=8, l2, LGD) on integer positions:
    the same graph and counters through the kernels and the plain versions,
    every kernel launched."""
    x = _data((3000, 3), 47, "l2", True, card)
    cfg = construct.BuildConfig(k=8, wave=256, lgd=True)

    def seed_fn(wave, pos, W, n_valid):
        g = torch.Generator().manual_seed(wave)
        return torch.randint(0, max(n_valid, 1), (W, cfg.n_seeds), generator=g)

    ops.reset_launch_counts()
    g_k, st_k = construct.build(x, cfg, seed_fn=seed_fn, device=card)
    brute.brute_force_knn(x, x, 8, device=card)
    counts = ops.launch_counts()
    assert all(counts[n] > 0 for n in ("gather_distance", "fused_expand", "pairwise_distance"))
    _route_plain(monkeypatch)
    g_p, st_p = construct.build(x, cfg, seed_fn=seed_fn, device=card)
    _graph_fields_equal(g_k, g_p)
    assert int(st_k.n_comps) == int(st_p.n_comps)


def test_registered_metric_refused_before_any_launch(card):
    """A metric registered with ``core.metrics.register`` has no kernel:
    each ``ops`` entry refuses it on CUDA tensors, naming it, and nothing
    launches."""
    from repro_torch.core import metrics

    @metrics.register("linf_card")
    def _linf(q, x):
        return (q[..., :, None, :] - x[..., None, :, :]).abs().amax(-1)

    try:
        x, q = _data((64, 16), 1, "l2", True, card), _data((4, 16), 2, "l2", True, card)
        idx = torch.randint(0, 64, (4, 12), device=card, dtype=torch.int32)
        B, e, H = 4, 8, 64
        beam = (torch.full((B, e), -1, dtype=torch.int32, device=card),
                torch.full((B, e), float("inf"), device=card),
                torch.zeros((B, e), dtype=torch.bool, device=card),
                torch.full((B, H), -1, dtype=torch.int32, device=card),
                torch.full((B, H), float("inf"), device=card))
        ops.reset_launch_counts()
        for call in (lambda: ops.pairwise_distance(q, x, "linf_card"),
                     lambda: ops.gather_distance(q, x, idx, "linf_card"),
                     lambda: ops.expand_step(q, x, idx, *beam, metric="linf_card")):
            with pytest.raises(KeyError, match="'linf_card'"):
                call()
        assert not any(ops.launch_counts().values())
    finally:
        del metrics._REGISTRY["linf_card"]


def _op_args(dev, B=6, C=5, d=16, n=40, H=64, e=4):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, d, generator=g)
    q = torch.randn(B, d, generator=g)
    idx = torch.randint(-1, n, (B, C), generator=g, dtype=torch.int32)
    beam = [torch.randint(0, n, (B, e), generator=g, dtype=torch.int32),
            torch.rand(B, e, generator=g), torch.zeros(B, e, dtype=torch.bool)]
    hashes = [torch.full((B, H), -1, dtype=torch.int32), torch.full((B, H), float("inf"))]
    return q.to(dev), x.to(dev), idx.to(dev), [t.to(dev) for t in beam], [t.to(dev) for t in hashes]


def test_registered_ops_pass_opcheck(card):
    """The three kernels' registered operators (schema, fake form, the
    declared writes of ``fused_expand``'s hash) at one small shape each."""
    q, x, idx, beam, hashes = _op_args(card)
    sq = (x * x).sum(1)
    torch.library.opcheck(distance.PAIRWISE_OP, (q, x, sq, "l2"))
    torch.library.opcheck(gather_dist.GATHER_OP, (q, x, idx, sq, None, "l2"))
    torch.library.opcheck(expand.EXPAND_OP, (q, x, idx, *beam, *hashes, sq, None, "l2", 8))
    dt = ops.pairwise_distance(q, x)
    best = (beam[1].contiguous(), beam[0].contiguous())
    alive = torch.rand(x.shape[0] - 3, device=card) < 0.7
    torch.library.opcheck(tile_topk_lib.TILE_TOPK_OP,
                          (dt, *best, alive, idx[:, 0].long(), 40, x.shape[0] + 20))


def test_launch_counts_count_through_the_registered_ops(card):
    q, x, idx, beam, hashes = _op_args(card)
    ops.reset_launch_counts()
    ops.pairwise_distance(q, x)
    ops.gather_distance(q, x, idx)
    ops.expand_step(q, x, idx, *beam, *hashes)
    ops.tile_topk(ops.pairwise_distance(q, x), beam[1], beam[0], 0, x.shape[0])
    counts = ops.launch_counts()
    assert counts["pairwise_distance"] == 2
    assert counts["gather_distance"] == counts["fused_expand"] == counts["tile_topk"] == 1


# ---------------------------------------------------------------- tile_topk
# k from one to the kernel's largest (each list length, 32 and 33 on either
# side of the insertion form), rows from one to the exact cell's 10,000
TOPK_K = [1, 8, 10, 20, 32, 33, 64, 1024]
TOPK_M = [1, 4, 96, 10_000]
TOPK_CASES = ["ties", "specials", "masks", "short", "few"]
SPECIAL_BITS = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00000, 0x3F800000, 0xBF800000], dtype=np.uint32)


def _tile_steps(case, m, k, dev):
    """Two chained tiles of one case: [(dt, lo, n_valid, alive slice,
    exclude_ids)].  ``ties``: small integers at T = 1,024 (every row 16-byte
    aligned); ``specials``: integers mixed with ±0.0, ±inf and NaN of both
    signs at T = 1,030 (rows alternately aligned, with a 2-column tail), the
    second tile a view one float off alignment (the 4-byte path); ``masks``:
    ``n_valid`` inside the second tile, ``alive`` and ``exclude_ids``;
    ``short``: a short second tile; ``few``: 3 valid candidates."""
    rng = np.random.RandomState(len(case) * 1000 + k + m)
    T = 1030 if case == "specials" else 1024
    n = 2 * T - (100 if case == "short" else 0)
    a = rng.randint(0, 4, (2, m, T)).astype(np.float32)
    if case == "specials":
        pick = rng.rand(2, m, T) < 0.3
        a = np.where(pick, SPECIAL_BITS[rng.randint(0, 8, (2, m, T))].view(np.float32), a)
    tiles = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n_valid = {"masks": T + 300, "few": 3}.get(case, n)
    alive = (torch.from_numpy(rng.rand(n) < 0.6).to(dev)
             if case in ("masks", "short") else None)
    excl = (torch.from_numpy(rng.randint(0, n, m)).to(dev)
            if case == "masks" else None)
    steps = []
    for t in range(2):
        dt = tiles[t]
        if case == "specials" and t == 1:
            flat = torch.empty(m * T + 1, device=dev)
            flat[1:] = dt.reshape(-1)
            dt = flat[1:].view(m, T)
        lo = t * T
        steps.append((dt, lo, n_valid, None if alive is None else alive[lo:lo + T], excl))
    return steps


@pytest.mark.parametrize("m", TOPK_M)
@pytest.mark.parametrize("k", TOPK_K)
def test_tile_topk_bit_identical_to_plain(card, k, m):
    """Every case over two chained tiles: ids and distance bits equal the
    plain version's, one launch a tile."""
    for case in TOPK_CASES:
        got = want = (torch.full((m, k), float("inf"), device=card),
                      torch.full((m, k), -1, dtype=torch.int32, device=card))
        for t, (dt, lo, n_valid, alive, excl) in enumerate(_tile_steps(case, m, k, card)):
            before = ops.launch_counts()["tile_topk"]
            got = ops.tile_topk(dt, *got, lo, n_valid, alive=alive, exclude_ids=excl)
            assert ops.launch_counts()["tile_topk"] == before + 1
            want = ref.tile_topk(dt, *want, lo, n_valid, alive=alive, exclude_ids=excl)
            torch.cuda.synchronize()
            assert torch.equal(got[1], want[1]), f"{case} tile {t}: ids"
            assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), \
                f"{case} tile {t}: distance bits"
        if case == "few" and k > 3:
            assert bool((got[1][:, 3:] == -1).all())


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine", "l2-masked"])
def test_brute_force_knn_through_tile_topk_matches_plain(card, metric, monkeypatch):
    """20,000 rows in three tiles (the last short): the kernel route equals
    the plain route bit for bit, one ``tile_topk`` launch a tile."""
    masked = metric == "l2-masked"
    metric = metric.removesuffix("-masked")
    x = _data((20_000, 32), 21, metric, False, card)
    q = _data((300, 32), 22, metric, False, card)
    kw = {}
    if masked:
        rng = np.random.RandomState(23)
        kw = dict(exclude_ids=torch.from_numpy(rng.randint(0, 20_000, 300)).int().to(card),
                  alive=torch.from_numpy(rng.rand(20_000) < 0.8).to(card), n_valid=19_000)
    ops.reset_launch_counts()
    got_i, got_d = brute.brute_force_knn(x, q, 20 if masked else 10, metric, device=card, **kw)
    assert ops.launch_counts()["tile_topk"] == 3
    monkeypatch.setattr(ops, "tile_topk", ref.tile_topk)
    want_i, want_d = brute.brute_force_knn(x, q, 20 if masked else 10, metric, device=card, **kw)
    assert ops.launch_counts()["tile_topk"] == 3
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32))


def test_tile_topk_refuses_k_above_its_largest(card):
    k = tile_topk_lib.MAX_K + 1
    dt = _data((4, 64), 24, "l2", False, card)
    before = ops.launch_counts()["tile_topk"]
    with pytest.raises(ValueError, match=f"k={k}"):
        ops.tile_topk(dt, torch.full((4, k), float("inf"), device=card),
                      torch.full((4, k), -1, dtype=torch.int32, device=card), 0, 64)
    assert ops.launch_counts()["tile_topk"] == before
