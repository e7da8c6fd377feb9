"""Port hierarchical seeding (``core.hierarchy`` and ``seed_mode="coarse"``)
against the JAX reference (``dispatch="reference"``), on the same numpy
inputs with the reference's key chains replayed and injected.

Exact tier, on integer data: the coarse build (landmark graph, member
rings, the graph it seeds and its counters) at W=1 and W=64, the coarse
search with its ``seed_cell``, ``derive_coarse``, and the level's
maintenance (``note_inserted``, ``purge_rows``, ``remap_rows``) through
insert, remove and compact.  Tolerance tier, on Gaussian data: coarse
recall within 0.01 of the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro.core import dynamic as jdynamic
from repro.core import graph as jgraph
from repro.core import hierarchy as jhier
from repro.core import search as jsearch
from repro_torch import convert
from repro_torch.core import construct as tconstruct
from repro_torch.core import dynamic as tdynamic
from repro_torch.core import graph as tgraph
from repro_torch.core import hierarchy as thier
from repro_torch.core import search as tsearch

torch.set_num_threads(2)

N, D, L = 600, 8, 48
W64 = dict(k=8, wave=64, beam=24, n_seeds=4, hash_slots=512, max_iters=32, lgd=True,
           seed_mode="coarse", coarse_landmarks=L, coarse_members=4)


def _both(n, d, kw, seed, x):
    """The reference's coarse build from ``PRNGKey(seed)`` and the port's
    from the replayed landmarks and entry points."""
    g_j, st_j, c_j = jconstruct.build(
        jnp.asarray(x), jconstruct.BuildConfig(dispatch="reference", **kw),
        jax.random.PRNGKey(seed), return_coarse=True,
    )
    Lc = min(kw["coarse_landmarks"], n)
    inject = tp.coarse_build_kw(jax.random.PRNGKey(seed), n, Lc, kw["n_seeds"])
    g_t, st_t, c_t = tconstruct.build(
        torch.from_numpy(x), tconstruct.BuildConfig(**kw), return_coarse=True,
        device="cpu", **inject,
    )
    return (g_j, st_j, c_j), (g_t, st_t, c_t)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


@pytest.fixture(scope="module")
def data():
    return tp.int_data(N, D, seed=7)


@pytest.fixture(scope="module")
def built(data):
    return _both(N, D, W64, 1, data)


def test_default_landmarks_match():
    for n in (4, 600, 100_000, 10**8):
        assert thier.default_landmarks(n) == jhier.default_landmarks(n)


@pytest.mark.parametrize("which", ["W=1", "W=64"])
def test_coarse_build_bit_identical(data, built, which):
    """Graph, level and counters, landmark build and seed assignment
    charged, members appended by the wave commits."""
    if which == "W=1":
        kw = dict(W64, wave=1, n_seed_init=16, k=6, beam=12, n_seeds=3, hash_slots=128,
                  max_iters=16, coarse_landmarks=12)
        x = data[:90]
        (g_j, st_j, c_j), (g_t, st_t, c_t) = _both(90, D, kw, 3, x)
    else:
        (g_j, st_j, c_j), (g_t, st_t, c_t) = built
    tp.assert_graphs_equal(g_t, g_j, which)
    tp.assert_coarse_equal(c_t, c_j, which)
    assert int(st_t.n_comps) == int(st_j.n_comps)
    assert int(st_t.n_inserted_edges) == int(st_j.n_inserted_edges)
    assert st_t.n_waves == int(st_j.n_waves)
    assert int(c_t.mem_ptr.sum()) > 0


def test_coarse_search_matches(data, built):
    (g_j, _, c_j), (g_t, _, c_t) = built
    jcfg = jconstruct.BuildConfig(dispatch="reference", **W64).search_config()
    tcfg = tconstruct.BuildConfig(**W64).search_config()
    q = tp.int_data(16, D, seed=42)
    key = jax.random.PRNGKey(3)
    want = jsearch.search(g_j, jnp.asarray(data), jnp.asarray(q), key, jcfg, coarse=c_j)
    seeds, cseeds = tp.search_entry(key, 16, jcfg.n_seeds, N, L)
    got = tsearch.search(g_t, torch.from_numpy(data), torch.from_numpy(q), tcfg, seeds=seeds,
                         coarse_seeds=cseeds, coarse=c_t, device="cpu")
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert bool((got.seed_cell >= 0).all())
    with pytest.raises(ValueError, match="coarse"):
        tsearch.search(g_t, torch.from_numpy(data), torch.from_numpy(q), tcfg, device="cpu")
    rand = tsearch.search(g_t, torch.from_numpy(data), torch.from_numpy(q),
                          dataclasses.replace(tcfg, seed_mode="random"), seeds=seeds,
                          device="cpu")
    assert bool((rand.seed_cell == -1).all())


def test_level_maintenance_matches(data, built):
    """The level carried over from the reference as numpy, then
    nearest_landmark, note_inserted, purge_rows and remap_rows on it (purge
    from the (cap,) mask equals the reference's equality test against the
    removed ids)."""
    (_, _, c_j), (_, _, c_t) = built
    tp.assert_coarse_equal(convert.coarse_from_numpy(tp.coarse_numpy(c_j)), c_j, "from numpy")
    np.testing.assert_array_equal(
        thier.nearest_landmark(c_t.points, torch.from_numpy(data), "l2", chunk=100).numpy(),
        np.asarray(jhier.nearest_landmark(c_j.points, jnp.asarray(data), "l2",
                                          dispatch="reference", chunk=100)))
    rng = np.random.RandomState(0)
    rows = np.concatenate([rng.randint(0, N, 30), [-1, -1]]).astype(np.int32)
    cells = np.concatenate([rng.randint(-1, L, 30), [3, -1]]).astype(np.int32)
    tp.assert_coarse_equal(
        thier.note_inserted(c_t, torch.from_numpy(rows), torch.from_numpy(cells)),
        jax.jit(jhier.note_inserted)(c_j, jnp.asarray(rows), jnp.asarray(cells)))
    victims = np.unique(np.concatenate([np.asarray(c_j.landmark_rows)[:5],
                                        np.asarray(c_j.members)[:6, 0], [0, 1, 2]]))
    victims = victims[victims >= 0].astype(np.int32)
    mask = torch.zeros(N, dtype=torch.bool)
    mask[torch.from_numpy(victims).long()] = True
    tp.assert_coarse_equal(thier.purge_rows(c_t, mask),
                           jax.jit(jhier.purge_rows)(c_j, jnp.asarray(victims)))
    id_map = np.where(rng.rand(N) < 0.8, np.arange(N), -1)
    id_map = np.where(id_map >= 0, np.cumsum(id_map >= 0) - 1, -1).astype(np.int32)
    tp.assert_coarse_equal(thier.remap_rows(c_t, torch.from_numpy(id_map)),
                           jax.jit(jhier.remap_rows)(c_j, jnp.asarray(id_map)))


def test_derive_coarse_matches(data, built):
    """Landmarks from the alive rows only, every alive row assigned."""
    (g_j, _, _), (g_t, _, _) = built
    victims = np.arange(0, N, 9, dtype=np.int32)
    jcfg = jconstruct.BuildConfig(dispatch="reference", **W64)
    g_j = jdynamic.remove(g_j, jnp.asarray(data), jnp.asarray(victims), "l2")
    g_t = tdynamic.remove(g_t, torch.from_numpy(data), torch.from_numpy(victims), "l2")
    key = jax.random.PRNGKey(11)
    want = jhier.derive_coarse(g_j, jnp.asarray(data), jcfg, key)
    kw = tp.derive_coarse_kw(key, np.asarray(g_j.alive), int(g_j.n_valid), L, W64["n_seeds"])
    got = thier.derive_coarse(g_t, torch.from_numpy(data), tconstruct.BuildConfig(**W64),
                              landmark_rows=kw["landmark_rows"], seed_fn=kw["landmark_seed_fn"],
                              device="cpu")
    tp.assert_coarse_equal(got, want)
    assert not bool(np.isin(got.landmark_rows.numpy(), victims).any())
    # the default draw (a torch generator) is a valid level too
    own = thier.derive_coarse(g_t, torch.from_numpy(data), tconstruct.BuildConfig(**W64),
                              generator=torch.Generator().manual_seed(0), device="cpu")
    rows = own.landmark_rows.numpy()
    assert len(set(rows.tolist())) == L and g_t.alive[torch.from_numpy(rows).long()].all()


def test_insert_maintains_members(data, built):
    """An insertion wave appends each new row to its winning cell; the
    insert that derives its own level replays the reference too."""
    (g_j, _, c_j), (g_t, _, c_t) = built
    extra = tp.int_data(80, D, seed=8)
    cap = N + 80
    x = np.concatenate([data, extra])
    jcfg = jconstruct.BuildConfig(dispatch="reference", **W64)
    tcfg = tconstruct.BuildConfig(**W64)
    key = jax.random.PRNGKey(2)
    gj_grown = jgraph.grow_graph(g_j, cap)
    gt_grown = tgraph.grow_graph(g_t, cap)
    tp.assert_graphs_equal(gt_grown, gj_grown, "grow")
    g1_j, st_j, c1_j = jdynamic.insert(gj_grown, jnp.asarray(x), 80, jcfg, key, coarse=c_j)
    g1_t, st_t, c1_t = tdynamic.insert(gt_grown, torch.from_numpy(x), 80, tcfg, coarse=c_t,
                                       device="cpu", **tp.insert_kw(key, 4, n_landmarks=L))
    tp.assert_graphs_equal(g1_t, g1_j, "insert")
    tp.assert_coarse_equal(c1_t, c1_j, "insert")
    assert int(st_t.n_comps) == int(st_j.n_comps)
    assert int(c1_t.mem_ptr.sum()) > int(c_t.mem_ptr.sum())
    # no level passed: the insert derives one from the graph first
    g2_j, _, c2_j = jdynamic.insert(gj_grown, jnp.asarray(x), 80, jcfg, key)
    kw = tp.insert_kw(key, 4, coarse_derive=(np.asarray(gj_grown.alive), N, L))
    g2_t, _, c2_t = tdynamic.insert(gt_grown, torch.from_numpy(x), 80, tcfg, device="cpu", **kw)
    tp.assert_graphs_equal(g2_t, g2_j, "insert, derived level")
    tp.assert_coarse_equal(c2_t, c2_j, "insert, derived level")


def test_gaussian_coarse_recall_within_tolerance(built):
    """N(0,1) rows at the exact tier's shapes: graph recall within 0.01 of
    the reference and within 0.03 of random seeding, and the coarse
    machinery charged (more comps than a random-seeded build)."""
    x = tp.gauss_data(N, D, seed=5)
    (g_j, st_j, _), (g_t, st_t, c_t) = _both(N, D, W64, 0, x)
    r_t, r_j = tp.graph_recalls(x, g_t, g_j)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    g_r, st_r = tconstruct.build(torch.from_numpy(x), tconstruct.BuildConfig(
        **dict(W64, seed_mode="random")), generator=torch.Generator().manual_seed(0),
        device="cpu")
    r_r, _ = tp.graph_recalls(x, g_r, g_j)
    assert r_t >= r_r - 0.03, (r_t, r_r)  # as test_hierarchy.py holds the reference
    assert int(st_t.n_comps) > int(st_r.n_comps)
    assert bool((c_t.landmark_rows >= 0).all())
