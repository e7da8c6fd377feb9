"""Port search: EHC steps and whole searches against the JAX reference on a
JAX-built graph brought over with ``repro_torch.convert``.

Integer-valued data keeps every l2/ip/l1 sum exact, and the entry points are
replayed from the reference's key, so every field of the search state must
match bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from repro.core import brute as jbrute
from repro.core import graph as jgraph
from repro.core import search as jsearch
from repro_torch import convert
from repro_torch.core import brute as tbrute
from repro_torch.core import search as tsearch
from repro_torch.obs import InMemoryTracker

torch.set_num_threads(2)

N, D, K = 400, 8, 8
STATE = ("beam_ids", "beam_dist", "beam_exp", "vis_ids", "vis_dist", "n_comps", "hash_full")
RESULT = ("ids", "dists", "vis_ids", "vis_dist", "n_comps", "n_iters", "converged", "hash_full")


@pytest.fixture(scope="module")
def data():
    return tp.int_data(N, D, seed=3)


@pytest.fixture(scope="module")
def built(data):
    """A reference graph over the first 300 rows (rows beyond unallocated)
    with planted λ, so the LGD filters have teeth, and its reverse lists."""
    g = tp.jax_exact_seed_graph(jnp.asarray(data), 300, K, "l2")
    lam = np.random.RandomState(4).randint(0, 3, g.nbr_lam.shape).astype(np.int32)
    return jax.jit(jgraph.rebuild_reverse)(g._replace(nbr_lam=jnp.asarray(lam)))


# the reference's init_state is not jitted; one compile beats op-by-op eager
j_init_state = jax.jit(jsearch.init_state, static_argnums=4)


def _cfgs(**kw):
    base = {**dict(k=K, beam=16, n_seeds=4, hash_slots=256, max_iters=12), **kw}
    return jsearch.SearchConfig(dispatch="reference", **base), tsearch.SearchConfig(**base)


def _assert_state_equal(got, want, fields, err):
    for name in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=f"{err} {name}",
        )


def test_convert_round_trip(built):
    fields = tp.jax_graph_numpy(built)
    back = convert.graph_to_numpy(convert.graph_from_numpy(fields))
    for name in tp.GRAPH_FIELDS:
        np.testing.assert_array_equal(back[name], fields[name], err_msg=name)
        assert back[name].dtype == fields[name].dtype, name


@pytest.mark.parametrize("H", [256, 16])
def test_init_state_matches(data, built, H):
    """Seed dedupe, masking, gather, hash insert (H=16 collides) and merge."""
    jcfg, tcfg = _cfgs(hash_slots=H)
    q = data[100:110]
    key = jax.random.PRNGKey(5)
    want = j_init_state(built, jnp.asarray(data), jnp.asarray(q), key, jcfg)
    seeds = tp.search_seeds(key, len(q), jcfg.n_seeds, int(built.n_valid))
    got = tsearch.init_state(
        tp.to_torch_graph(built), torch.from_numpy(data), torch.from_numpy(q),
        torch.from_numpy(seeds), tcfg,
    )
    _assert_state_equal(got, want, STATE, f"H={H}")


@pytest.mark.parametrize(
    "flags",
    [dict(), dict(use_lgd_mask=True), dict(use_lgd_mask=True, hard_diversify=True),
     dict(use_reverse=False)],
    ids=["plain", "lgd", "hard", "no-reverse"],
)
def test_single_steps_match(data, built, flags):
    """Three chained EHC iterations: candidate selection (λ mask, reverse
    edges, alive/range masks, row dedupe) and the expansion step; with a
    tracker the step gives the same state."""
    jcfg, tcfg = _cfgs(**flags)
    q = data[200:208]
    key = jax.random.PRNGKey(6)
    x_j, q_j = jnp.asarray(data), jnp.asarray(q)
    g_t = tp.to_torch_graph(built)
    jst = j_init_state(built, x_j, q_j, key, jcfg)
    seeds = tp.search_seeds(key, len(q), jcfg.n_seeds, int(built.n_valid))
    tst = tsearch.init_state(g_t, torch.from_numpy(data), torch.from_numpy(q),
                             torch.from_numpy(seeds), tcfg)
    j_prepare = jax.jit(lambda st: jsearch._prepare_expansion(built, st, jcfg)[0])
    j_step = jax.jit(jsearch._make_step(built, x_j, q_j, jcfg))
    for it in range(3):
        tc, _ = tsearch._prepare_expansion(g_t, tst, tcfg)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(j_prepare(jst)), err_msg=f"iter {it} cands")
        jst = j_step(jst)
        traced = tsearch.step(g_t, torch.from_numpy(data), torch.from_numpy(q),
                              tst._replace(vis_ids=tst.vis_ids.clone(),
                                           vis_dist=tst.vis_dist.clone()),
                              tcfg, tracker=InMemoryTracker())
        tst = tsearch.step(g_t, torch.from_numpy(data), torch.from_numpy(q), tst, tcfg)
        _assert_state_equal(tst, jst, STATE + ("n_iters", "done"), f"iter {it}")
        _assert_state_equal(traced, tst, STATE + ("n_iters", "done"), f"traced iter {it}")


@pytest.mark.parametrize("metric,H", [("l2", 256), ("ip", 64), ("l1", 128)])
def test_whole_search_matches(data, built, metric, H):
    """Full searches to convergence; H=64 saturates some lanes' hashes."""
    jcfg, tcfg = _cfgs(metric=metric, hash_slots=H, use_lgd_mask=True, max_iters=20)
    q = data[::25][:16] + 1.0
    key = jax.random.PRNGKey(7)
    want = jsearch.search(built, jnp.asarray(data), jnp.asarray(q), key, jcfg)
    seeds = tp.search_seeds(key, len(q), jcfg.n_seeds, int(built.n_valid))
    got = tsearch.search(
        tp.to_torch_graph(built), torch.from_numpy(data), torch.from_numpy(q), tcfg,
        seeds=torch.from_numpy(seeds), device="cpu",
    )
    _assert_state_equal(got, want, RESULT, f"{metric} H={H}")
    if H == 64:
        assert bool(got.hash_full.any())


def test_search_recall_on_gaussian_graph():
    """N(0,1) data: float sums differ by order between the packages, so the
    same walk is held to the reference's recall and comps, not its bits."""
    x = tp.gauss_data(N, D, seed=8)
    g = tp.jax_exact_seed_graph(jnp.asarray(x), N, K, "l2")
    jcfg, tcfg = _cfgs(use_lgd_mask=False)
    q = x[:40] + 0.01
    key = jax.random.PRNGKey(9)
    want = jsearch.search(g, jnp.asarray(x), jnp.asarray(q), key, jcfg)
    seeds = tp.search_seeds(key, len(q), jcfg.n_seeds, N)
    got = tsearch.search(tp.to_torch_graph(g), torch.from_numpy(x), torch.from_numpy(q), tcfg,
                         seeds=torch.from_numpy(seeds), device="cpu")
    truth, _ = jbrute.brute_force_knn(jnp.asarray(x), jnp.asarray(q), K)
    r_want = float(jbrute.recall_at_k(want.ids, truth, K))
    r_got = float(jbrute.recall_at_k(jnp.asarray(got.ids.numpy()), truth, K))
    assert r_got >= 0.95 and abs(r_got - r_want) <= 0.01, (r_got, r_want)
    np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=1e-5, atol=1e-4)


def test_search_default_seeds_from_generator(data, built):
    """Without injected seeds the entry points come from the generator: the
    same generator state gives the same search."""
    tcfg = _cfgs()[1]
    g_t, x, q = tp.to_torch_graph(built), torch.from_numpy(data), torch.from_numpy(data[:6])
    a = tsearch.search(g_t, x, q, tcfg, generator=torch.Generator().manual_seed(1), device="cpu")
    b = tsearch.search(g_t, x, q, tcfg, generator=torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a.ids, b.ids) and torch.equal(a.n_comps, b.n_comps)
    assert int(a.n_comps.min()) > 0


def test_auto_hash_slots_and_config_checks():
    for beam, iters in [(40, 60), (16, 8), (64, 4096), (10, 300)]:
        assert tsearch.auto_hash_slots(beam, iters) == jsearch.auto_hash_slots(beam, iters)
    assert tsearch.SearchConfig(beam=40, max_iters=60).hash_slots == 2048
    with pytest.raises(ValueError):
        tsearch.SearchConfig(k=20, beam=10)
    with pytest.raises(ValueError):
        tsearch.SearchConfig(hash_slots=1000)


def _children(trk, parent, names):
    """Each span named in ``names`` under one of the ``parent`` spans: the
    parent's id for each, in order, and every child's root is its parent's."""
    by_id = {e["id"]: e for e in trk.spans(parent)}
    out = []
    for name in names:
        kids = trk.spans(name)
        assert all(by_id[c["parent_id"]]["root"] == c["root"] for c in kids), name
        out.append(sorted(c["parent_id"] for c in kids))
    return sorted(by_id), out


@pytest.mark.parametrize("max_iters", [20, 3], ids=["converged", "capped"])
def test_search_with_a_tracker_is_bit_identical_and_spans_each_iteration(data, built, max_iters):
    """The same bits with a tracker; one ``search/step`` a trip of the loop
    (the slowest lane's ``n_iters``), one ``done`` read more when every lane
    converged, and each step's three phases under it."""
    tcfg = _cfgs(use_lgd_mask=True, max_iters=max_iters)[1]
    g_t, x, q = tp.to_torch_graph(built), torch.from_numpy(data), torch.from_numpy(data[::20] + 1.0)
    plain = tsearch.search(g_t, x, q, tcfg, generator=torch.Generator().manual_seed(4), device="cpu")
    trk = InMemoryTracker()
    got = tsearch.search(g_t, x, q, tcfg, generator=torch.Generator().manual_seed(4), device="cpu",
                         tracker=trk)
    for name in ("ids", "dists", "n_comps", "n_iters", "hash_full", "converged"):
        assert torch.equal(getattr(got, name), getattr(plain, name)), name
    converged = bool(got.converged.all())
    assert converged == (max_iters == 20)
    n = int(got.n_iters.max())
    assert len(trk.spans("search/step")) == n
    assert len(trk.spans("search/done_read")) == n + converged
    (init,) = trk.spans("search/init")
    assert init["depth"] == 0 and init["root"] == init["id"]
    steps, kids = _children(trk, "search/step", ("search/select", "search/expand", "search/update"))
    assert kids == [steps] * 3
    assert all(e["depth"] == 0 for e in trk.spans("search/step") + trk.spans("search/done_read"))


@pytest.mark.parametrize("tile", [96, 400, 8192])
def test_brute_force_with_a_tracker_is_bit_identical_and_spans_each_tile(data, tile):
    """The same bits with a tracker; ``ceil(n / tile)`` tiles, each with one
    pairwise and one top-k child."""
    x, q = torch.from_numpy(data), torch.from_numpy(data[:12] + 1.0)
    want = tbrute.brute_force_knn(x, q, K, n_valid=350, tile=tile, device="cpu")
    trk = InMemoryTracker()
    got = tbrute.brute_force_knn(x, q, K, n_valid=350, tile=tile, device="cpu", tracker=trk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(trk.spans("brute/tile")) == -(-N // min(tile, N))
    tiles, kids = _children(trk, "brute/tile", ("brute/pairwise", "brute/topk"))
    assert kids == [tiles] * 2
    assert all(e["root"] == e["id"] for e in trk.spans("brute/tile"))
