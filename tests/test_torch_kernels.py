"""Port kernels: each plain PyTorch version against the JAX Pallas kernel it
replaces (interpret mode, as ``tests/test_kernels.py`` runs them), plus the
hash/sort primitives the kernels share with the rest of the port.

Inputs come from numpy and go to both packages.  On small-integer data the
l2/ip/l1 sums are exact in fp32, so ids, masks, comps and hash contents, and
those distances, must match exactly; on N(0,1) data the distances differ by
summation order only (norms decomposition vs broadcast sum vs dot), within
``rtol=1e-5, atol=1e-4``.  The CUDA kernels themselves are held against the
same plain versions on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from repro.core import segments as jseg
from repro.kernels import distance as jdistance
from repro.kernels import expand as jexpand
from repro.kernels import gather_dist as jgather
from repro.kernels import ref as jref
from repro_torch.core import segments as tseg
from repro_torch.kernels import distance as tdistance
from repro_torch.kernels import expand as texpand
from repro_torch.kernels import gather_dist as tgather
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

METRICS = ["l2", "ip", "cosine", "l1", "chi2"]
EXACT = ("l2", "ip", "l1")  # exact fp32 sums on integer-valued data
RTOL, ATOL = 1e-5, 1e-4
EXPAND_FIELDS = ("beam_ids", "beam_dist", "beam_exp", "vis_ids", "vis_dist", "comps")


def _data(shape, seed, metric, integer):
    rng = np.random.RandomState(seed)
    if integer:
        return rng.randint(0, 8, shape).astype(np.float32)
    a = rng.randn(*shape).astype(np.float32)
    return np.abs(a) if metric == "chi2" else a


def _check(got, want, exact, err=""):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=err)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=err)


@pytest.mark.parametrize("metric", METRICS + ["l2-cached"])
@pytest.mark.parametrize("integer", [False, True])
def test_pairwise_plain_matches_pallas(metric, integer):
    cached = metric == "l2-cached"
    metric = metric.removesuffix("-cached")
    q = _data((17, 24), 0, metric, integer)
    x = _data((53, 24), 1, metric, integer)
    xn = (x * x).sum(-1) if cached else None
    want = jdistance.pairwise_distance(
        jnp.asarray(q), jnp.asarray(x), metric=metric,
        x_sq_norms=None if xn is None else jnp.asarray(xn), interpret=True,
    )
    got = tref.pairwise_distance(
        torch.from_numpy(q), torch.from_numpy(x), metric,
        x_sq_norms=None if xn is None else torch.from_numpy(xn),
    )
    _check(got, want, integer and metric in EXACT, metric)


@pytest.mark.parametrize("metric, d, aligned, form", [
    ("l2", 128, True, "wgmma"), ("ip", 8, True, "wgmma"), ("l2", 136, True, "wgmma"),
    ("ip", 512, True, "wgmma"), ("l2", 100, True, "simt"), ("ip", 36, True, "simt"),
    ("l2", 128, False, "simt"), ("l1", 128, True, "simt"), ("chi2", 64, True, "simt"),
])
def test_bf16_pairwise_form_choice(metric, d, aligned, form):
    """Two bf16 operands take the tensor-core form for the product metrics
    at 16-byte rows on aligned pointers, and the SIMT form otherwise."""
    assert tdistance.bf16_form(metric, d, aligned) == form


@pytest.mark.parametrize("d", [128, 100])
def test_bf16_pairwise_wrapper_refuses_cpu_tensors(d):
    """Either bf16 form refuses CPU tensors (they take the plain version
    through ``ops``) and counts no launch."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    x = torch.rand(50, d).bfloat16()
    with pytest.raises(ValueError, match="CUDA"):
        tdistance.pairwise_distance(x[:4], x, "l2", x_sq_norms=torch.ones(50))
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("integer", [False, True])
def test_gather_plain_matches_pallas(metric, integer):
    q = _data((6, 16), 2, metric, integer)
    x = _data((50, 16), 3, metric, integer)
    idx = np.random.RandomState(4).randint(-1, 50, (6, 12)).astype(np.int32)
    sq = (x * x).sum(-1)
    want = jgather.gather_distance(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(idx), metric=metric,
        sq_norms=jnp.asarray(sq), interpret=True,
    )
    got = tref.gather_distance(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(idx), metric,
        sq_norms=torch.from_numpy(sq),
    )
    assert np.array_equal(np.isinf(np.asarray(got)), idx < 0)
    _check(got, want, integer and metric in EXACT, metric)


def _gather_ids(B, C, n, seed):
    """Uniform ids with -1s; the first query's all -1, the second's one id
    repeated."""
    idx = np.random.RandomState(seed).randint(-1, n, (B, C)).astype(np.int32)
    idx[0] = -1
    idx[1] = 7
    return idx


# the CUDA kernel's shapes: a seed gather's chunk (C=8, d=128) and a large
# candidate count (C=512, d=256, four of the Pallas kernel's 128-wide blocks)
@pytest.mark.parametrize("B,C,d", [(4, 8, 128), (3, 512, 256)])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("integer", [False, True])
def test_gather_plain_matches_pallas_wide(B, C, d, metric, integer):
    n = 600
    q = _data((B, d), 5, metric, integer)
    x = _data((n, d), 6, metric, integer)
    idx = _gather_ids(B, C, n, 7)
    sq = (x * x).sum(-1)
    want = jgather.gather_distance(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(idx), metric=metric,
        sq_norms=jnp.asarray(sq), interpret=True,
    )
    got = tref.gather_distance(
        torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(idx), metric,
        sq_norms=torch.from_numpy(sq),
    )
    assert np.array_equal(np.isinf(np.asarray(got)), idx < 0)
    _check(got, want, integer and metric in EXACT, metric)


def _expand_inputs(B, C, e, H, n, seed):
    """A mid-search state: beam from random ids, a hash holding some of them,
    candidates mixing visited ids, new ids, duplicates and -1."""
    rng = np.random.RandomState(seed)
    beam_ids = rng.randint(0, n, (B, e)).astype(np.int32)
    beam_ids[:, e // 2:] = -1
    beam_dist = np.where(beam_ids >= 0, np.sort(rng.randint(0, 50, (B, e)), 1), np.inf)
    beam_exp = (rng.rand(B, e) < 0.5) | (beam_ids < 0)
    cands = rng.randint(0, n, (B, C)).astype(np.int32)
    cands[:, : C // 4] = beam_ids[:, : C // 4]  # already visited
    cands[rng.rand(B, C) < 0.15] = -1
    cands[:, -1] = cands[:, 0]  # a duplicate id in one row
    return cands, beam_ids, beam_dist.astype(np.float32), beam_exp


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("H", [32, 256])
def test_expand_plain_matches_pallas(metric, H):
    """Chained steps, integer data: every output field of the plain version
    equals the fused Pallas kernel's (interpret mode).  H=32 forces probe
    exhaustion and same-slot collisions."""
    B, C, e, n, d, P = 5, 20, 12, 60, 8, 4
    x = _data((n, d), 5, metric, integer=True)
    q = x[:B] + 1.0
    sq = (x * x).sum(-1)
    cands, bi, bd, be = _expand_inputs(B, C, e, H, n, seed=6)
    vi = np.full((B, H), -1, np.int32)
    vd = np.full((B, H), np.inf, np.float32)
    # plant the visited half of the beam into the hash first
    jstate = (jnp.asarray(bi), jnp.asarray(bd), jnp.asarray(be), jnp.asarray(vi), jnp.asarray(vd))
    tstate = tuple(torch.from_numpy(np.array(a)) for a in (bi, bd, be, vi, vd))
    exact = metric in EXACT
    rng = np.random.RandomState(7)
    for step in range(3):
        want = jexpand.fused_expand(
            jnp.asarray(q), jnp.asarray(x), jnp.asarray(cands), *jstate,
            metric=metric, probes=P, sq_norms=jnp.asarray(sq), interpret=True,
        )
        got = texpand.expand_reference(
            torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(cands), *tstate,
            metric=metric, probes=P, sq_norms=torch.from_numpy(sq),
        )
        for name, a, b in zip(EXPAND_FIELDS, got, want):
            float_field = name in ("beam_dist", "vis_dist")
            _check(a, b, exact or not float_field, f"step {step} {name}")
        jstate, tstate = tuple(want[:5]), tuple(got[:5])
        cands = np.where(rng.rand(*cands.shape) < 0.5, cands, rng.randint(0, n, cands.shape))
        cands = cands.astype(np.int32)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("C,e,P,H", [(70, 40, 16, 32), (130, 66, 1, 64)])
def test_expand_plain_matches_pallas_wide(precision, C, e, P, H):
    """The plain version at the shapes the card tests hold the CUDA kernel
    to: C > 64 (two candidate passes), e > C/2, P = 16 (two probe batches)
    and P = 1, d = 100 (scalar rows for bf16 and int8), at every storage
    type; chained steps on integer data, every field bit for bit against the
    fused Pallas kernel (interpret mode)."""
    B, n, d = 3, 90, 100
    x = _data((n, d), 12, "l2", integer=True)
    q = x[:B] + 1.0
    sq = (x * x).sum(-1)
    enc_j, enc_t = tp.encode_both(x, precision) if precision != "fp32" else (None, None)
    cands, bi, bd, be = _expand_inputs(B, C, e, H, n, seed=13)
    jstate = tuple(map(jnp.asarray, (bi, bd, be, np.full((B, H), -1, np.int32),
                                     np.full((B, H), np.inf, np.float32))))
    tstate = tuple(torch.from_numpy(np.array(a)) for a in jstate)
    rng = np.random.RandomState(14)
    for step in range(2):
        want = jexpand.fused_expand(
            jnp.asarray(q), jnp.asarray(x), jnp.asarray(cands), *jstate, metric="l2", probes=P,
            sq_norms=jnp.asarray(sq), enc=enc_j, precision=precision, interpret=True,
        )
        got = texpand.expand_reference(
            torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(cands), *tstate,
            metric="l2", probes=P, sq_norms=torch.from_numpy(sq), enc=enc_t, precision=precision,
        )
        for name, a, b in zip(EXPAND_FIELDS, got, want):
            _check(a, b, True, f"step {step} {name}")
        jstate, tstate = tuple(want[:5]), tuple(got[:5])
        cands = np.where(rng.rand(*cands.shape) < 0.5, cands, rng.randint(0, n, cands.shape))
        cands = cands.astype(np.int32)


def test_expand_hash_updates_in_place():
    """The plain version writes the recorded slots into the caller's hash
    tensors and returns those same tensors."""
    B, C, e, H, n = 3, 10, 8, 64, 40
    x = torch.from_numpy(_data((n, 6), 8, "l2", integer=True))
    cands, bi, bd, be = (torch.from_numpy(np.array(a)) for a in _expand_inputs(B, C, e, H, n, 9))
    vi = torch.full((B, H), -1, dtype=torch.int32)
    vd = torch.full((B, H), float("inf"))
    out = texpand.expand_reference(x[:B], x, cands, bi, bd, be, vi, vd, probes=4)
    assert out[3] is vi and out[4] is vd
    for b in range(B):
        recorded = set(vi[b][vi[b] >= 0].tolist())
        assert recorded and recorded <= set(cands[b].tolist())
        assert len(recorded) <= int(out[5][b])  # duplicates and collisions record once


def test_same_slot_collision_later_candidate_wins():
    """Two fresh ids hashing to one slot: the later one in candidate order is
    recorded, as XLA resolves the reference's scatter."""
    H = 16
    ids = torch.arange(2000, dtype=torch.int32)
    slots = texpand.probe_slots(ids, H, 1)[:, 0]
    a, b = [int(i) for i in ids[slots == slots[0]][:2]]
    x = np.arange(2001 * 2, dtype=np.float32).reshape(2001, 2) % 7
    cands = np.array([[a, b]], np.int32)
    args = (np.zeros((1, 2), np.float32), x, cands, np.full((1, 4), -1, np.int32),
            np.full((1, 4), np.inf, np.float32), np.ones((1, 4), bool),
            np.full((1, H), -1, np.int32), np.full((1, H), np.inf, np.float32))
    want = jexpand.fused_expand(*map(jnp.asarray, args), probes=1, interpret=True)
    got = texpand.expand_reference(*(torch.from_numpy(np.array(a_)) for a_ in args), probes=1)
    assert int(got[3][0, int(slots[0])]) == b
    for name, g, w in zip(EXPAND_FIELDS, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def test_probe_slots_match_uint32_wraparound():
    ids = np.array([0, 1, 7, 65535, 123456789, 2**31 - 1, 1_000_000, 16_777_215], np.int32)
    for H, P in [(1024, 8), (65536, 3), (16, 4)]:
        want = jexpand.probe_slots(jnp.asarray(ids), H, P)
        got = texpand.probe_slots(torch.from_numpy(ids), H, P)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hash_lookup_and_probe_state_match():
    rng = np.random.RandomState(10)
    B, H, C, P = 4, 32, 24, 4
    vis = np.where(rng.rand(B, H) < 0.6, rng.randint(0, 100, (B, H)), -1).astype(np.int32)
    vd = np.where(vis >= 0, rng.rand(B, H), np.inf).astype(np.float32)
    ids = rng.randint(-1, 100, (B, C)).astype(np.int32)
    for got, want in zip(
        texpand.hash_probe_state(torch.from_numpy(vis), torch.from_numpy(ids), P),
        jax.jit(jexpand.hash_probe_state, static_argnums=2)(jnp.asarray(vis), jnp.asarray(ids), P),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(
        texpand.hash_lookup(torch.from_numpy(vis), torch.from_numpy(vd), torch.from_numpy(ids), P),
        jax.jit(jexpand.hash_lookup, static_argnums=3)(
            jnp.asarray(vis), jnp.asarray(vd), jnp.asarray(ids), P),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dedupe_beam_matches():
    ids = np.array([[3, 1, 3, -1, -1, 1, 4], [2, 2, 2, 0, -1, 0, 5]], np.int32)
    dist = np.arange(14, dtype=np.float32).reshape(2, 7)
    exp = np.zeros((2, 7), bool)
    for got, want in zip(
        texpand.dedupe_beam(*map(torch.from_numpy, (ids, dist, exp))),
        jexpand.dedupe_beam(*map(jnp.asarray, (ids, dist, exp))),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_smallest_ties_and_signed_zeros():
    """Ties go to the lower column, -0.0 ranks before +0.0 and +inf pads last,
    exactly as ``lax.top_k`` on the negated distances."""
    d = np.array([[1.0, 0.0, -0.0, 1.0, np.inf, 0.0, -1.0, np.inf],
                  [np.inf, np.inf, 2.0, 2.0, 2.0, -0.0, 0.0, 5.0]], np.float32)
    ids = np.arange(16, dtype=np.int32).reshape(2, 8)
    for k in (3, 8):
        gd, gi = tref.topk_smallest(torch.from_numpy(d), torch.from_numpy(ids), k)
        wd, wi = jref.topk_smallest(jnp.asarray(d), jnp.asarray(ids), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(np.signbit(gd.numpy()), np.signbit(np.asarray(wd)))


def test_segment_primitives_match():
    rng = np.random.RandomState(11)
    keys = np.sort(rng.randint(0, 12, 60)).astype(np.int32)
    keys[-5:] = 15  # padding sentinels past num_segments=12
    pay = rng.randint(0, 1000, 60).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.segment_rank(torch.from_numpy(keys)).numpy(),
        np.asarray(jax.jit(jseg.segment_rank)(jnp.asarray(keys))),
    )
    np.testing.assert_array_equal(
        tseg.segment_counts(torch.from_numpy(keys), 12).numpy(),
        np.asarray(jax.jit(jseg.segment_counts, static_argnums=1)(jnp.asarray(keys), 12)),
    )
    (gb,), gc = tseg.grouped_top_r(torch.from_numpy(keys), [torch.from_numpy(pay)], [-1], 12, 3)
    (wb,), wc = jax.jit(
        lambda k, p: jseg.grouped_top_r(k, [p], [-1], 12, 3)
    )(jnp.asarray(keys), jnp.asarray(pay))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    ids = rng.randint(-1, 6, (7, 9)).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.mask_row_duplicates(torch.from_numpy(ids)).numpy(),
        np.asarray(jax.jit(jseg.mask_row_duplicates)(jnp.asarray(ids))),
    )
