"""The port's metric registry (``core.metrics.register``, ``names``,
``one_to_many``, ``is_matmul_metric``) against the reference's, and a
metric registered in both packages run end to end through the plain
versions.

The registered metric is L∞ (the largest coordinate difference).  The
fixture registers it in both registries and removes it from both
afterwards; nothing of the reference is edited.  On small-integer rows every
L∞ distance is exact in fp32, so brute force, an n=600, W=64 build with the
reference's seeds replayed, and a search of it give equal ids, distances
and comparison counts.  On a CUDA tensor ``kernels.ops`` refuses the metric
before any launch (``ops.require_kernel_metric``, whose message is checked
here on the CPU); the ``cuda``-marked case checks the refusal on the card,
as ``tests/test_torch_cuda.py::test_registered_metric_refused_before_any_launch``
does in a file without JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import brute as jbrute
from repro.core import metrics as jmetrics
from repro.core import search as jsearch
from repro.kernels import ref as jref
from repro_torch.core import brute as tbrute
from repro_torch.core import construct as tconstruct
from repro_torch.core import metrics as tmetrics
from repro_torch.core import search as tsearch
from repro_torch.kernels import distance, expand, gather_dist, ops, ref

torch.set_num_threads(2)

N, D = 600, 8
W64 = dict(k=8, wave=64, beam=24, n_seeds=4, hash_slots=512, max_iters=32, lgd=True,
           metric="linf")


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


@pytest.fixture(scope="module")
def linf():
    """L∞ registered in both packages for this module's tests."""

    @jmetrics.register("linf")
    def _jax_linf(q, x):
        q, x = q.astype(jnp.float32), x.astype(jnp.float32)
        return jnp.max(jnp.abs(q[:, None, :] - x[None, :, :]), axis=-1)

    @tmetrics.register("linf")
    def _torch_linf(q, x):
        return (q[..., :, None, :] - x[..., None, :, :]).abs().amax(-1)

    yield "linf"
    del jmetrics._REGISTRY["linf"]
    del tmetrics._REGISTRY["linf"]


def _gather_case(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 16, (40, D)).astype(np.float32)
    q = rng.randint(0, 16, (5, D)).astype(np.float32)
    idx = rng.randint(-1, 40, (5, 12)).astype(np.int32)
    return x, q, idx


@pytest.mark.parametrize("path", ["gather", "expand", "pairwise"])
def test_unknown_metric_raises_key_error_naming_it(path):
    """The plain versions refuse a metric that is neither built in nor
    registered, as the reference's ``metrics.pairwise`` does (they used to
    compute chi2 for it)."""
    x, q, idx = (torch.from_numpy(a) for a in _gather_case())
    with pytest.raises(KeyError, match="'foo'"):
        jref.gather_distance(jnp.asarray(q.numpy()), jnp.asarray(x.numpy()),
                             jnp.asarray(idx.numpy()), "foo")
    with pytest.raises(KeyError, match="'foo'"):
        if path == "gather":
            ref.gather_distance(q, x, idx, "foo")
        elif path == "pairwise":
            ops.pairwise_distance(q, x, "foo")
        else:
            B, e, H = q.shape[0], 8, 64
            ops.expand_step(
                q, x, idx, torch.full((B, e), -1, dtype=torch.int32),
                torch.full((B, e), float("inf")), torch.zeros((B, e), dtype=torch.bool),
                torch.full((B, H), -1, dtype=torch.int32), torch.full((B, H), float("inf")),
                metric="foo")


def test_registry_api_matches_reference(linf):
    assert tmetrics.names() == jmetrics.names()
    assert "linf" in tmetrics.names()
    for m in tmetrics.names() + ["foo"]:
        assert tmetrics.is_matmul_metric(m) == jmetrics.is_matmul_metric(m), m
    x, q, _ = _gather_case(1)
    for m in tmetrics.names():
        got = tmetrics.one_to_many(m, torch.from_numpy(q[0]), torch.from_numpy(x))
        want = np.asarray(jmetrics.one_to_many(m, jnp.asarray(q[0]), jnp.asarray(x)))
        assert got.shape == want.shape == (x.shape[0],)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5, err_msg=m)


def test_registered_metric_gather_and_pairwise_match(linf):
    x, q, idx = _gather_case(2)
    want = np.asarray(jref.gather_distance(jnp.asarray(q), jnp.asarray(x), jnp.asarray(idx),
                                           linf))
    got = ops.gather_distance(torch.from_numpy(q), torch.from_numpy(x), torch.from_numpy(idx),
                              linf)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), linf).numpy(),
        np.asarray(jmetrics.pairwise(linf, jnp.asarray(q), jnp.asarray(x))))


def test_registered_metric_build_and_search_match_reference(linf):
    """Brute force, a W=64 LGD build with the reference's entry points
    replayed, and an EHC search of the built graph: ids, distances and
    comparison counts equal the reference's (``dispatch="reference"``)."""
    x = tp.int_data(N, D, seed=5)
    q = tp.int_data(16, D, seed=6)
    want_ids, want_d = jbrute.brute_force_knn(jnp.asarray(x), jnp.asarray(q), 8, linf,
                                              use_pallas=False)
    got_ids, got_d = tbrute.brute_force_knn(torch.from_numpy(x), torch.from_numpy(q), 8, linf,
                                            device="cpu")
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))

    (g_j, st_j), (g_t, st_t) = tp.build_both(x, 3, **W64)
    tp.assert_graphs_equal(g_t, g_j, "linf build")
    assert int(st_t.n_comps) == int(st_j.n_comps)
    assert int(st_t.n_inserted_edges) == int(st_j.n_inserted_edges)

    key = jax.random.PRNGKey(4)
    jcfg = jsearch.SearchConfig(k=8, beam=24, n_seeds=4, metric=linf, use_lgd_mask=True,
                                dispatch="reference")
    want = jsearch.search(g_j, jnp.asarray(x), jnp.asarray(q), key, jcfg)
    got = tsearch.search(g_t, torch.from_numpy(x), torch.from_numpy(q),
                         tconstruct.BuildConfig(**W64).search_config(),
                         seeds=tp.search_entry(key, 16, 4, N), device="cpu")
    for name in ("ids", "dists", "n_comps", "hash_full"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("kernel", [distance, gather_dist], ids=["distance", "gather_dist"])
def test_cuda_guard_names_metric_and_kernel_metrics(linf, kernel):
    """The check ``ops`` runs on a CUDA tensor before any launch."""
    ops.require_kernel_metric("l2", kernel.KERNEL_METRIC)
    with pytest.raises(KeyError) as err:
        ops.require_kernel_metric(linf, kernel.KERNEL_METRIC)
    msg = str(err.value)
    assert "'linf'" in msg and "no CUDA kernel" in msg
    for m in kernel.KERNEL_METRIC:
        assert repr(m) in msg, m
    assert expand.KERNEL_METRIC is gather_dist.KERNEL_METRIC


@pytest.mark.cuda
def test_registered_metric_refused_on_the_card_before_any_launch(linf):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    x, q, idx = (torch.from_numpy(a).to(dev) for a in _gather_case())
    B, e, H = q.shape[0], 8, 64
    beam = (torch.full((B, e), -1, dtype=torch.int32, device=dev),
            torch.full((B, e), float("inf"), device=dev),
            torch.zeros((B, e), dtype=torch.bool, device=dev),
            torch.full((B, H), -1, dtype=torch.int32, device=dev),
            torch.full((B, H), float("inf"), device=dev))
    ops.reset_launch_counts()
    for call in (lambda: ops.pairwise_distance(q, x, linf),
                 lambda: ops.gather_distance(q, x, idx, linf),
                 lambda: ops.expand_step(q, x, idx, *beam, metric=linf)):
        with pytest.raises(KeyError, match="'linf'"):
            call()
    assert not any(ops.launch_counts().values())
