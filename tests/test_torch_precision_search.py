"""Port precision path, part 2: one compressed expansion step and whole
searches at bf16, int8 and pq, held against the JAX package on the same
numpy inputs, with the reference's encoding carried across by
``repro_torch.convert.encoded_from_numpy``.

Small-integer data keeps the l2/ip dots exact in fp32 and is held exactly by
a bf16 table; an int8 dot is an exact integer sum times the row's scale, one
rounding in both packages.  So every field compares bit for bit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from repro.core import search as jsearch
from repro.kernels import expand as jexpand
from repro.kernels import precision as jprec
from repro_torch.core import search as tsearch
from repro_torch.kernels import expand as texpand
from repro_torch.kernels import ops as tops
from repro_torch.kernels import precision as tprec

torch.set_num_threads(2)

EXPAND_FIELDS = ("beam_ids", "beam_dist", "beam_exp", "vis_ids", "vis_dist", "comps")
RESULT = ("ids", "dists", "vis_ids", "vis_dist", "n_comps", "n_iters", "converged", "hash_full")


# ------------------------------------------------------- expansion step


def _expand_inputs(B, C, e, n, seed):
    rng = np.random.RandomState(seed)
    beam_ids = rng.randint(0, n, (B, e)).astype(np.int32)
    beam_ids[:, e // 2:] = -1
    beam_dist = np.where(beam_ids >= 0, np.sort(rng.randint(0, 50, (B, e)), 1), np.inf)
    beam_exp = (rng.rand(B, e) < 0.5) | (beam_ids < 0)
    cands = rng.randint(0, n, (B, C)).astype(np.int32)
    cands[:, : C // 4] = beam_ids[:, : C // 4]
    cands[rng.rand(B, C) < 0.15] = -1
    cands[:, -1] = cands[:, 0]
    return cands, beam_ids, beam_dist.astype(np.float32), beam_exp


@pytest.mark.parametrize(
    "metric,precision", [("l2", "bf16"), ("l2", "int8"), ("ip", "int8"), ("l1", "bf16")])
def test_expand_step_bitwise(metric, precision):
    """Two chained steps on integer data: every output of the plain
    expansion equals the reference's plain expansion and its fused Pallas
    kernel (interpret mode) bit for bit, hash included."""
    B, C, e, H, n, d, P = 5, 20, 12, 64, 60, 16, 4
    rng = np.random.RandomState(3)
    x = rng.randint(0, 8, (n, d)).astype(np.float32)
    q = x[:B] + 1.0
    sq = (x * x).sum(-1)
    enc_j, enc_t = tp.encode_both(x, precision)
    cands, bi, bd, be = _expand_inputs(B, C, e, n, seed=4)
    vi = np.full((B, H), -1, np.int32)
    vd = np.full((B, H), np.inf, np.float32)
    state = (bi, bd, be, vi, vd)
    for step in range(2):
        kw_j = dict(metric=metric, probes=P, sq_norms=jnp.asarray(sq), enc=enc_j,
                    precision=precision)
        want = jexpand.expand_reference(
            jnp.asarray(q), jnp.asarray(x), jnp.asarray(cands), *map(jnp.asarray, state), **kw_j)
        kern = jexpand.fused_expand(
            jnp.asarray(q), jnp.asarray(x), jnp.asarray(cands), *map(jnp.asarray, state),
            interpret=True, **kw_j)
        got = texpand.expand_reference(
            torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(cands),
            *(torch.from_numpy(np.array(a)) for a in state),
            metric=metric, probes=P, sq_norms=torch.from_numpy(sq), enc=enc_t,
            precision=precision)
        for name, a, b, c in zip(EXPAND_FIELDS, got, want, kern):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), f"step {step} {name}")
            np.testing.assert_array_equal(np.asarray(a), np.asarray(c), f"step {step} {name} Pallas")
        state = tuple(np.array(a) for a in want[:5])
        cands = np.where(rng.rand(*cands.shape) < 0.5, cands, rng.randint(0, n, cands.shape))
        cands = cands.astype(np.int32)


def test_expansion_refuses_pq():
    x = torch.zeros(10, 4)
    ids = torch.zeros(1, 2, dtype=torch.int32)
    args = (x[:1], x, ids, ids, torch.zeros(1, 2), torch.zeros(1, 2, dtype=torch.bool),
            torch.full((1, 16), -1, dtype=torch.int32), torch.zeros(1, 16))
    enc = tprec.EncodedData(codes=torch.zeros(10, 1, dtype=torch.uint8),
                            codebook=torch.zeros(1, 256, 4))
    with pytest.raises(ValueError, match="pq"):
        texpand.expand_reference(*args, enc=enc, precision="pq")
    # the kernel takes a table, never PQ codes
    with pytest.raises(ValueError, match="float32, bfloat16 or int8"):
        texpand.fused_expand(args[0], enc.codes, *args[2:])
    with pytest.raises(ValueError, match="rerank_keep"):
        tops.expand_step(*args, enc=enc, precision="pq")


# --------------------------------------------------------------- searches

N, D, K = 400, 16, 8


@pytest.fixture(scope="module")
def data():
    return tp.int_data(N, D, seed=3, high=8)


@pytest.fixture(scope="module")
def built(data):
    """A reference exact graph over the first 300 rows."""
    return tp.jax_exact_seed_graph(jnp.asarray(data), 300, K, "l2")


def _search_both(data, built, q, key, enc_j, enc_t, **kw):
    base = {**dict(k=K, beam=16, n_seeds=4, hash_slots=256, max_iters=12), **kw}
    jcfg = jsearch.SearchConfig(dispatch="reference", **base)
    want = jsearch.search(built, jnp.asarray(data), jnp.asarray(q), key, jcfg, enc=enc_j)
    seeds = tp.search_seeds(key, len(q), jcfg.n_seeds, int(built.n_valid))
    got = tsearch.search(
        tp.to_torch_graph(built), torch.from_numpy(data), torch.from_numpy(q),
        tsearch.SearchConfig(**base), seeds=torch.from_numpy(seeds), enc=enc_t, device="cpu",
    )
    return got, want


def _assert_result_equal(got, want, err):
    for name in RESULT:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=f"{err} {name}")


@pytest.mark.parametrize(
    "precision,metric", [("bf16", "l2"), ("int8", "l2"), ("int8", "ip"), ("bf16", "l1")])
def test_compressed_search_bitwise(data, built, precision, metric):
    """Whole searches with the engine at bf16/int8, seeds from the
    reference's key and its encoding carried across."""
    q = data[::25][:16] + 1.0
    scale = built.row_scale if precision == "int8" else None
    enc_j, enc_t = tp.encode_both(data, precision, row_scale=scale)
    got, want = _search_both(data, built, q, jax.random.PRNGKey(7), enc_j, enc_t,
                             precision=precision, metric=metric, use_lgd_mask=True)
    _assert_result_equal(got, want, f"{precision} {metric}")
    # without an enc the port encodes x itself, int8 from the graph's scales
    derived, _ = _search_both(data, built, q, jax.random.PRNGKey(7), enc_j, None,
                              precision=precision, metric=metric, use_lgd_mask=True)
    _assert_result_equal(derived, want, f"{precision} {metric} derived")


def test_pq_search_bitwise(data, built):
    """PQ rank-then-rerank: with an integer codebook every ADC score is
    exact, so the survivors (rerank_factor=1 keeps 8 of up to 24
    candidates) and the whole search match bit for bit."""
    q = data[::25][:16] + 1.0
    cb = np.round(np.asarray(jprec.train_pq_codebook(jnp.asarray(data))))
    enc_j, enc_t = tp.encode_both(data, "pq", codebook=jnp.asarray(cb))
    got, want = _search_both(data, built, q, jax.random.PRNGKey(8), enc_j, enc_t,
                             precision="pq", rerank_factor=1)
    _assert_result_equal(got, want, "pq")


def test_pq_rerank_keep_all_equals_fp32():
    """With rerank_keep >= C the prerank drops nothing, so the pq search is
    the fp32 search bit for bit (only exact distances enter the hash or the
    beam); the port of the reference's test of the same name, on its data."""
    rng = np.random.RandomState(11)
    x = rng.rand(400, 16).astype(np.float32)
    g = tp.jax_exact_seed_graph(jnp.asarray(x), 400, 8, "l2")
    q = torch.from_numpy(np.random.RandomState(12).rand(16, 16).astype(np.float32))
    g_t, xt = tp.to_torch_graph(g), torch.from_numpy(x)
    base = tsearch.SearchConfig(k=8, beam=16, n_seeds=4, metric="l2")
    seeds = torch.from_numpy(tp.search_seeds(jax.random.PRNGKey(3), 16, 4, 400))
    res32 = tsearch.search(g_t, xt, q, base, seeds=seeds, device="cpu")
    respq = tsearch.search(
        g_t, xt, q, dataclasses.replace(base, precision="pq", rerank_factor=1000),
        seeds=seeds, device="cpu")
    assert torch.equal(res32.ids, respq.ids)
    assert torch.equal(res32.dists, respq.dists)
    assert torch.equal(respq.n_comps, res32.n_comps)


def test_search_config_checks():
    with pytest.raises(ValueError):
        tsearch.SearchConfig(precision="fp16")
    with pytest.raises(ValueError):
        tsearch.SearchConfig(rerank_factor=0)
    cfg = tsearch.SearchConfig(precision="pq", rerank_factor=3)
    assert (cfg.precision, cfg.rerank_factor) == ("pq", 3)
