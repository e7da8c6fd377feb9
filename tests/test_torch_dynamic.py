"""Port dynamic updates (``core.dynamic``: insert, remove with the λ repair,
compact) and ``grow_graph``/``trim_graph`` against the JAX reference
(``dispatch="reference"``), on the same numpy inputs with the reference's
entry points replayed.

Exact tier, on integer data: every graph array, the counters, the packed
data and the id map are equal bit for bit, inserting at W=1 and W=64.
Tolerance tier, on Gaussian data: search recall after churn within 0.01 of
the reference.  The λ repair is also held against a plain oracle that
loops over rows, as ``tests/test_dynamic.py`` holds the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro.core import dynamic as jdynamic
from repro.core import graph as jgraph
from repro.core import search as jsearch
from repro_torch.core import brute as tbrute
from repro_torch.core import construct as tconstruct
from repro_torch.core import dynamic as tdynamic
from repro_torch.core import graph as tgraph
from repro_torch.core import metrics as tmetrics
from repro_torch.core import search as tsearch

torch.set_num_threads(2)

N0, N_EXTRA, D = 400, 100, 8
N = N0 + N_EXTRA
CFG = dict(k=8, wave=64, lgd=True, beam=16, n_seeds=4, hash_slots=512, max_iters=32)
SCFG = dict(k=8, beam=32, n_seeds=8, hash_slots=1024, max_iters=48)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


def _built(x, seed=0):
    """The reference's and the port's builds over the first N0 rows, grown
    to N rows of capacity."""
    (g_j, _), (g_t, _) = tp.build_both(x[:N0], seed, **CFG)
    return jgraph.grow_graph(g_j, N), tgraph.grow_graph(g_t, N)


@pytest.fixture(scope="module")
def data():
    return tp.int_data(N, D, seed=0)


@pytest.fixture(scope="module")
def grown(data):
    return _built(data)


def _copy(g):
    return tgraph.KNNGraph(*(f.clone() if isinstance(f, torch.Tensor) else f for f in g))


def _assert_untouched(g, before):
    for name in tp.GRAPH_FIELDS:
        a, b = getattr(g, name), getattr(before, name)
        assert (a == b).all() if isinstance(a, torch.Tensor) else a == b, name


def test_grow_and_trim_match(grown):
    g_j, g_t = grown
    tp.assert_graphs_equal(g_t, g_j)
    assert (g_t.nbr_ids[N0:] == -1).all() and torch.isinf(g_t.nbr_dist[N0:]).all()
    assert not g_t.alive[N0:].any() and (g_t.sq_norms[N0:] == 0).all()
    tp.assert_graphs_equal(tgraph.trim_graph(g_t, N0), jgraph.trim_graph(g_j, N0))
    with pytest.raises(ValueError, match="n_valid"):
        tgraph.trim_graph(g_t, N0 - 1)


@pytest.mark.parametrize("wave", [1, 64])
def test_insert_bit_identical(data, grown, wave):
    """``insert`` is ``build(initial=...)`` over ``x[:start + n_new]``; the
    caller's graph comes back untouched."""
    g_j, g_t = grown
    n_new = 12 if wave == 1 else N_EXTRA
    jcfg = jconstruct.BuildConfig(dispatch="reference", **dict(CFG, wave=wave))
    tcfg = tconstruct.BuildConfig(**dict(CFG, wave=wave))
    key = jax.random.PRNGKey(1)
    before = _copy(g_t)
    g1_j, st_j = jdynamic.insert(g_j, jnp.asarray(data), n_new, jcfg, key)
    g1_t, st_t = tdynamic.insert(g_t, torch.from_numpy(data), n_new, tcfg, device="cpu",
                                 **tp.insert_kw(key, CFG["n_seeds"]))
    tp.assert_graphs_equal(g1_t, g1_j, f"W={wave}")
    assert int(st_t.n_comps) == int(st_j.n_comps)
    assert int(st_t.n_inserted_edges) == int(st_j.n_inserted_edges)
    assert st_t.n_waves == int(st_j.n_waves) == -(-n_new // wave)
    assert g1_t.n_valid == N0 + n_new
    _assert_untouched(g_t, before)


def _oracle_decrements(g, x, victims, metric="l2"):
    """Plain loop over rows of the Rule-3 undo, before the re-pack."""
    ids, dist = g.nbr_ids.numpy(), g.nbr_dist.numpy()
    cap, k = ids.shape
    removed = np.zeros(cap, bool)
    removed[victims] = True
    dec = np.zeros((cap, k), np.int64)
    for r in range(cap):
        valid = ids[r] >= 0
        hit = valid & removed[np.maximum(ids[r], 0)]
        if not hit.any():
            continue
        vecs = torch.from_numpy(x[np.maximum(ids[r], 0)])
        dm = tmetrics.pairwise(metric, vecs, vecs).numpy()
        for s in np.nonzero(hit)[0]:
            for j in range(s + 1, k):
                if valid[j] and not hit[j] and dm[s, j] < dist[r, s]:
                    dec[r, j] += 1
    return dec


@pytest.mark.parametrize("metric", ["l2", "l1"])
def test_remove_bit_identical_and_repair_exact(data, grown, metric):
    """Remove with the λ repair over the rows it touches only, in chunks
    (``_REPAIR_ROWS`` cut to 16 here), equals the reference's repair over
    every row; out-of-range and -1 ids are ignored; the input is untouched."""
    g_j, g_t = grown
    rng = np.random.RandomState(3)
    victims = rng.choice(N0, 40, replace=False).astype(np.int32)
    ids = np.concatenate([victims, [-1, N + 5, -7]]).astype(np.int32)
    want = jdynamic.remove(g_j, jnp.asarray(data), jnp.asarray(ids), metric)
    before = _copy(g_t)
    chunk = tdynamic._REPAIR_ROWS
    tdynamic._REPAIR_ROWS = 16
    try:
        got = tdynamic.remove(g_t, torch.from_numpy(data), torch.from_numpy(ids), metric)
    finally:
        tdynamic._REPAIR_ROWS = chunk
    tp.assert_graphs_equal(got, want, metric)
    _assert_untouched(g_t, before)
    # the repair against the plain oracle, per (row, member) pair
    dec = _oracle_decrements(g_t, data, victims, metric)
    want_lam = np.maximum(g_t.nbr_lam.numpy() - dec, 0)
    removed = set(victims.tolist())
    for r in range(N0):
        got_pairs = {int(m): int(l) for m, l in zip(got.nbr_ids[r], got.nbr_lam[r]) if m >= 0}
        if r in removed:
            assert not got_pairs
            continue
        want_pairs = {int(m): int(want_lam[r, s]) for s, m in enumerate(g_t.nbr_ids[r])
                      if m >= 0 and int(m) not in removed}
        assert got_pairs == want_pairs, r
    assert int(dec.sum()) > 0
    off = tdynamic.remove(g_t, torch.from_numpy(data), torch.from_numpy(ids), metric,
                          repair_lambda=False)
    assert torch.equal(off.nbr_ids, got.nbr_ids) and torch.equal(off.nbr_dist, got.nbr_dist)
    inv = tgraph.graph_invariants_ok(got)
    assert all(bool(v.all()) for v in inv.values())
    assert not got.alive[torch.from_numpy(victims).long()].any()
    assert (got.sq_norms[torch.from_numpy(victims).long()] == 0).all()


def test_compact_bit_identical(data, grown):
    """Graph, re-packed data and id map; caches move with their rows and
    the reverse side is the canonical rebuild."""
    g_j, g_t = grown
    victims = np.random.RandomState(4).choice(N0, N0 // 4, replace=False).astype(np.int32)
    g_j = jdynamic.remove(g_j, jnp.asarray(data), jnp.asarray(victims), "l2")
    g_t = tdynamic.remove(g_t, torch.from_numpy(data), torch.from_numpy(victims), "l2")
    want_g, want_x, want_map = jdynamic.compact(g_j, jnp.asarray(data))
    before = _copy(g_t)
    got_g, got_x, got_map = tdynamic.compact(g_t, torch.from_numpy(data))
    tp.assert_graphs_equal(got_g, want_g)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))
    assert got_map.dtype == torch.int32 and got_g.n_valid == N0 - N0 // 4
    _assert_untouched(g_t, before)
    tp.assert_graphs_equal(tgraph.rebuild_reverse(got_g), want_g)
    tp.assert_graphs_equal(tgraph.attach_sq_norms(got_g, got_x), want_g)


def test_churn_recall_gaussian():
    """Insert the extra rows, remove them again: the search recall over
    the base rows stays within 0.05 of before (``tests/test_dynamic.py``)
    and within 0.01 of the reference's."""
    x = tp.gauss_data(N, D, seed=1)
    q = tp.gauss_data(64, D, seed=42)
    g_j, g_t = _built(x, seed=2)
    jcfg = jconstruct.BuildConfig(dispatch="reference", **CFG)
    key = jax.random.PRNGKey(1)
    g1_j, _ = jdynamic.insert(g_j, jnp.asarray(x), N_EXTRA, jcfg, key)
    g1_t, _ = tdynamic.insert(g_t, torch.from_numpy(x), N_EXTRA, tconstruct.BuildConfig(**CFG),
                              device="cpu", **tp.insert_kw(key, CFG["n_seeds"]))
    victims = np.arange(N0, N, dtype=np.int32)
    g2_j = jdynamic.remove(g1_j, jnp.asarray(x), jnp.asarray(victims), "l2")
    g2_t = tdynamic.remove(g1_t, torch.from_numpy(x), torch.from_numpy(victims), "l2")
    assert not (g2_t.nbr_ids >= N0).any() and not (g2_t.rev_ids >= N0).any()
    truth, _ = tbrute.brute_force_knn(torch.from_numpy(x[:N0]), torch.from_numpy(q), 8,
                                      device="cpu")
    skey = jax.random.PRNGKey(5)

    def recalls(g_jx, g_tx, n):
        want = jsearch.search(g_jx, jnp.asarray(x[:n]), jnp.asarray(q), skey,
                              jsearch.SearchConfig(dispatch="reference", **SCFG))
        got = tsearch.search(g_tx, torch.from_numpy(x[:n]), torch.from_numpy(q),
                             tsearch.SearchConfig(**SCFG),
                             seeds=tp.search_entry(skey, 64, SCFG["n_seeds"], g_tx.n_valid),
                             device="cpu")
        return (tbrute.recall_at_k(got.ids, truth, 8),
                tbrute.recall_at_k(torch.from_numpy(np.array(want.ids)), truth, 8))

    r0_t, r0_j = recalls(jgraph.trim_graph(g_j, N0), tgraph.trim_graph(g_t, N0), N0)
    r2_t, r2_j = recalls(g2_j, g2_t, N)
    assert abs(r2_t - r2_j) <= 0.01 and abs(r0_t - r0_j) <= 0.01, (r0_t, r0_j, r2_t, r2_j)
    assert r2_t >= r0_t - 0.05, (r0_t, r2_t)
