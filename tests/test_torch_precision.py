"""Port precision path, part 1: the codecs and the compressed gather
distance, each held against the JAX package on the same numpy inputs
(``test_torch_precision_search.py`` holds the expansion step and the
searches, ``test_torch_precision_build.py`` the builds).

On small-integer data the l2/ip dots are exact in fp32, and a bf16 table
holds small integers exactly, so l2/ip at both precisions and l1 at bf16
must match bit for bit (an int8 dot is one exact integer sum times the
row's scale, one rounding in both packages).  Elsewhere (cosine, chi2, int8
l1/chi2, whose dequantized elements are summed in another order) the
distances agree within ``rtol=1e-5, atol=1e-4``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from repro.kernels import gather_dist as jgather
from repro.kernels import precision as jprec
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.kernels import ops as tops
from repro_torch.kernels import precision as tprec
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)

METRICS = ["l2", "ip", "cosine", "l1", "chi2"]
RTOL, ATOL = 1e-5, 1e-4

j_gather_ref = jax.jit(jref.gather_distance, static_argnames=("metric", "precision"))


def _exact(metric, precision):
    return metric in ("l2", "ip") or (metric == "l1" and precision == "bf16")


def _check(got, want, exact, err=""):
    got, want = np.asarray(got), np.asarray(want)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=err)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=err)


# ---------------------------------------------------------------- codecs


def _codec_data():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.randn(300, 16),
        rng.randint(-20, 20, (100, 16)),
        np.zeros((2, 16)),  # zero scale: quantized through 1
        np.full((2, 16), 127 * 0.5),  # halfway codes round to even
    ]).astype(np.float32)
    return x


def test_bf16_and_int8_encodings_bitwise():
    x = _codec_data()
    for precision in ("bf16", "int8"):
        enc_j = tp.encoded_numpy(jprec.encode_dataset(jnp.asarray(x), precision))
        enc_t = tprec.encode_dataset(torch.from_numpy(x), precision)
        if precision == "bf16":
            assert enc_t.data.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                enc_t.data.view(torch.int16).numpy(), enc_j["data"].view(np.int16))
            # the bits carried across by convert equal the port's own encoding
            assert torch.equal(convert.encoded_from_numpy(enc_j).data, enc_t.data)
        else:
            assert enc_t.data.dtype == torch.int8 and enc_t.scale.dtype == torch.float32
            np.testing.assert_array_equal(enc_t.data.numpy(), enc_j["data"])
            np.testing.assert_array_equal(enc_t.scale.numpy(), enc_j["scale"])
    s = np.abs(x).max(1) * np.float32(1 / 127)
    np.testing.assert_array_equal(
        tprec.quantize_int8(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jprec.quantize_int8(jnp.asarray(x), jnp.asarray(s))))
    assert tprec.encode_dataset(torch.from_numpy(x), "fp32") is None
    with pytest.raises(ValueError):
        tprec.validate_precision("fp16")


@pytest.mark.parametrize("d", [16, 20, 7])
def test_pq_codebook_codes_and_adc(d):
    """Training within rtol 1e-5; codes exact given the reference's
    codebook; ADC tables and gathers within rtol 1e-5 for every metric."""
    rng = np.random.RandomState(d)
    x = rng.randn(700, d).astype(np.float32)
    assert tprec.pq_subspaces(d) == jprec.pq_subspaces(d)
    cb_j = np.array(jprec.train_pq_codebook(jnp.asarray(x)))
    cb_t = tprec.train_pq_codebook(torch.from_numpy(x))
    np.testing.assert_allclose(cb_t.numpy(), cb_j, rtol=1e-5, atol=1e-6)
    codes_j = np.array(jprec.pq_encode(jnp.asarray(x), jnp.asarray(cb_j)))
    codes_t = tprec.pq_encode(torch.from_numpy(x), torch.from_numpy(cb_j))
    assert codes_t.dtype == torch.uint8
    np.testing.assert_array_equal(codes_t.numpy(), codes_j)
    # row chunks do not change any row's code
    saved = tprec._ENCODE_ELEMS
    try:
        tprec._ENCODE_ELEMS = 3 * codes_t.shape[1] * tprec._PQ_K
        np.testing.assert_array_equal(
            tprec.pq_encode(torch.from_numpy(x), torch.from_numpy(cb_j)).numpy(), codes_j)
    finally:
        tprec._ENCODE_ELEMS = saved
    q = np.abs(rng.randn(5, d)).astype(np.float32)
    xa = np.abs(x)
    sq = (xa * xa).sum(-1)
    idx = rng.randint(-1, 700, (5, 33)).astype(np.int32)
    for metric in METRICS:
        lut_j = jprec.adc_tables(jnp.asarray(q), jnp.asarray(cb_j), metric)
        lut_t = tprec.adc_tables(torch.from_numpy(q), torch.from_numpy(cb_j), metric)
        np.testing.assert_allclose(lut_t.numpy(), np.asarray(lut_j), rtol=1e-5, atol=1e-5,
                                   err_msg=metric)
        want = jprec.adc_gather(lut_j, jnp.asarray(codes_j), jnp.asarray(idx), metric,
                                jnp.asarray(sq))
        got = tprec.adc_gather(lut_t, torch.from_numpy(codes_j), torch.from_numpy(idx),
                               metric, torch.from_numpy(sq))
        assert np.array_equal(np.isinf(got.numpy()), idx < 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=metric)
    for precision in jprec.PRECISIONS:
        assert tprec.bytes_per_dim(precision) == jprec.bytes_per_dim(precision)


# ------------------------------------------------- compressed gather distance


@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("metric", METRICS)
def test_compressed_gather_matches_reference_and_pallas(metric, precision):
    """Integer data at C = 1, 127, 128, 129, 300 (both sides of the Pallas
    engine's 128-wide candidate block), against the reference's plain
    version and its Pallas kernel in interpret mode; then Gaussian data
    against the plain version."""
    rng = np.random.RandomState(1)
    n, d, B = 400, 16, 3
    x = rng.randint(0, 8, (n, d)).astype(np.float32)
    x[5] = 0.0  # a zero row: scale 0, dequantized through 1
    q = rng.randint(0, 8, (B, d)).astype(np.float32)
    sq = (x * x).sum(-1)
    enc_j, enc_t = tp.encode_both(x, precision)
    exact = _exact(metric, precision)
    for C in (1, 127, 128, 129, 300):
        idx = rng.randint(-1, n, (B, C)).astype(np.int32)
        idx[0, 0] = 5
        args_j = (jnp.asarray(q), jnp.asarray(x), jnp.asarray(idx))
        want = j_gather_ref(*args_j, metric, sq_norms=jnp.asarray(sq), enc=enc_j,
                            precision=precision)
        kern = jgather.gather_distance(
            jnp.asarray(q), enc_j.data, jnp.asarray(idx), metric=metric,
            sq_norms=jnp.asarray(sq), row_scale=enc_j.scale, interpret=True)
        got = tref.gather_distance(
            torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(idx), metric,
            sq_norms=torch.from_numpy(sq), enc=enc_t, precision=precision)
        assert np.array_equal(np.isinf(got.numpy()), idx < 0)
        _check(got, want, exact, f"C={C} vs reference")
        _check(got, kern, exact, f"C={C} vs Pallas")
        # the routing point takes the plain version for CPU tensors
        routed = tops.gather_distance(
            torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(idx), metric,
            sq_norms=torch.from_numpy(sq), enc=enc_t, precision=precision)
        assert torch.equal(routed, got)
    xg = rng.randn(n, d).astype(np.float32)
    xg = np.abs(xg) if metric == "chi2" else xg
    qg = np.abs(rng.randn(B, d)).astype(np.float32)
    sqg = (xg * xg).sum(-1)
    enc_j, enc_t = tp.encode_both(xg, precision)
    idx = rng.randint(-1, n, (B, 129)).astype(np.int32)
    want = j_gather_ref(jnp.asarray(qg), jnp.asarray(xg), jnp.asarray(idx), metric,
                        sq_norms=jnp.asarray(sqg), enc=enc_j, precision=precision)
    got = tref.gather_distance(
        torch.from_numpy(qg), torch.from_numpy(xg), torch.from_numpy(idx), metric,
        sq_norms=torch.from_numpy(sqg), enc=enc_t, precision=precision)
    _check(got, want, False, "gaussian")


# the CUDA kernel's shapes: a seed gather's chunk (C=8, d=128) and a large
# candidate count (C=512, d=256)
@pytest.mark.parametrize("precision", ["bf16", "int8"])
@pytest.mark.parametrize("B,C,d", [(4, 8, 128), (3, 512, 256)])
@pytest.mark.parametrize("integer", [False, True])
def test_compressed_gather_matches_pallas_wide(precision, B, C, d, integer):
    """The plain compressed gather against the Pallas kernel in interpret
    mode under every metric: bit for bit on integer rows where the sums are
    exact, within rtol=1e-5, atol=1e-4 elsewhere.  The first query's ids are
    all -1, the second's one id repeated."""
    rng = np.random.RandomState(B + C + d)
    n = 600
    if integer:
        x = rng.randint(0, 8, (n, d)).astype(np.float32)
        q = rng.randint(0, 8, (B, d)).astype(np.float32)
    else:
        x = np.abs(rng.randn(n, d)).astype(np.float32)  # chi2 needs x, q >= 0
        q = np.abs(rng.randn(B, d)).astype(np.float32)
    idx = rng.randint(-1, n, (B, C)).astype(np.int32)
    idx[0] = -1
    idx[1] = 7
    sq = (x * x).sum(-1)
    enc_j, enc_t = tp.encode_both(x, precision)
    for metric in METRICS:
        kern = jgather.gather_distance(
            jnp.asarray(q), enc_j.data, jnp.asarray(idx), metric=metric,
            sq_norms=jnp.asarray(sq), row_scale=enc_j.scale, interpret=True)
        got = tref.gather_distance(
            torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(idx), metric,
            sq_norms=torch.from_numpy(sq), enc=enc_t, precision=precision)
        assert np.array_equal(np.isinf(got.numpy()), idx < 0), metric
        _check(got, kern, integer and _exact(metric, precision), metric)


def test_pq_gather_is_adc_on_either_route():
    rng = np.random.RandomState(2)
    x = rng.randn(300, 16).astype(np.float32)
    q = rng.randn(4, 16).astype(np.float32)
    sq = (x * x).sum(-1)
    idx = rng.randint(-1, 300, (4, 50)).astype(np.int32)
    enc_j, enc_t = tp.encode_both(x, "pq")
    for metric in ("l2", "ip", "cosine"):
        want = j_gather_ref(jnp.asarray(q), jnp.asarray(x), jnp.asarray(idx), metric,
                            sq_norms=jnp.asarray(sq), enc=enc_j, precision="pq")
        got = tops.gather_distance(
            torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(idx), metric,
            sq_norms=torch.from_numpy(sq), enc=enc_t, precision="pq")
        _check(got, want, False, metric)
