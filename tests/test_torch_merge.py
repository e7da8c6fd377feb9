"""Port divide-and-conquer merge steps (``core.merge``,
``core.hierarchy.fold_coarse``, ``kernels.ops.merge_proposals``) against the
JAX reference (``dispatch="reference"``).

The leaves are sub-graphs built by the reference and converted, and the
port replays the reference's key chains (``torch_parity.JaxDraws``): on
integer-valued data every graph array, coarse level and comparison count is
bit-identical.  On N(0,1) rows the second-hop distances are held to a
float64 oracle at the fp32 tolerance of ``tests/test_precision.py``.  The
merge tree at S = 2, 3 and 5 leaves and ``build_parallel`` are in
``test_torch_parallel_build.py``, NN-Descent in ``test_torch_nndescent.py``:
files of their own, so that each runs within 60 s on one worker (the
reference compiles once per shape, and each file keeps to few shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro.core import dynamic as jdynamic
from repro.core import hierarchy as jhier
from repro.core import merge as jmerge
from repro.index import ShardedIndex as JRouter
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import construct as tconstruct
from repro_torch.core import graph as tgraph
from repro_torch.core import hierarchy as thier
from repro_torch.core import merge as tmerge
from repro_torch.core.draws import TorchDraws
from repro_torch.index import ShardedIndex as TRouter
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)

N, D, K = 600, 8, 8
CFG = dict(k=K, metric="l2", wave=64, lgd=True, beam=24, n_seeds=4, hash_slots=512,
           max_iters=32, n_seed_init=64)
CHUNK = 128  # cross-search chunk: several chunks per side, the last padded


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


@pytest.fixture(scope="module")
def data():
    return tp.int_data(N, D, seed=0)


def _jcfg(**over):
    return jconstruct.BuildConfig(dispatch="reference", **{**CFG, **over})


def _tcfg(**over):
    return tconstruct.BuildConfig(**{**CFG, **over})


def _leaves(x, S, seed=1, **over):
    """S contiguous blocks of x built by the reference: (reference graphs,
    reference coarse levels, the port's copies of both)."""
    bounds = tconstruct.partition_bounds(len(x), S)
    gj, cj = [], []
    for s in range(S):
        g, _, c = jconstruct.build(jnp.asarray(x[bounds[s]:bounds[s + 1]]), _jcfg(**over),
                                   jax.random.PRNGKey(seed + s), return_coarse=True)
        gj.append(g)
        cj.append(c)
    gt = [tp.to_torch_graph(g) for g in gj]
    ct = [None if c is None else convert.coarse_from_numpy(tp.coarse_numpy(c)) for c in cj]
    return gj, cj, gt, ct


def _oracle_l2(q, x, idx):
    cand = x.astype(np.float64)[np.clip(idx, 0, len(x) - 1)]
    d = ((q.astype(np.float64)[:, None, :] - cand) ** 2).sum(-1)
    return np.where(idx >= 0, d, np.inf)


@pytest.mark.parametrize("kind", ["int", "gauss"])
def test_merge_proposals_matches_reference(data, kind, monkeypatch):
    """Second-hop proposals in row chunks (7 rows, a partial last chunk)
    equal the reference's unchunked call: ids, masks and comps bit for bit,
    distances bit for bit on integer rows and to the float64 oracle on
    N(0,1) rows."""
    x = data if kind == "int" else tp.gauss_data(N, D, seed=3)
    rng = np.random.RandomState(4)
    nt = 300
    xq, xt = x[nt:], x[:nt]
    hits = rng.randint(-1, nt, (len(xq), K)).astype(np.int32)
    t_nbr = rng.randint(-1, nt, (nt, K)).astype(np.int32)
    alive = rng.rand(nt) > 0.1
    sq = (xt.astype(np.float32) ** 2).sum(-1)
    want = jops.merge_proposals(jnp.asarray(xq), jnp.asarray(xt), jnp.asarray(hits),
                                jnp.asarray(t_nbr), jnp.asarray(alive), "l2",
                                dispatch="reference", sq_norms=jnp.asarray(sq), hop_top=5)
    monkeypatch.setattr(tops, "MERGE_PROPOSAL_ROWS", 7)
    got = tops.merge_proposals(torch.from_numpy(xq), torch.from_numpy(xt),
                               torch.from_numpy(hits), torch.from_numpy(t_nbr),
                               torch.from_numpy(alive), "l2", sq_norms=torch.from_numpy(sq),
                               hop_top=5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[2]) == int(want[2]) > 0
    if kind == "int":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    else:
        oracle = _oracle_l2(xq, xt, got[0].numpy())
        fin = np.isfinite(oracle)
        assert np.array_equal(fin, np.isfinite(got[1].numpy()))
        np.testing.assert_allclose(got[1].numpy()[fin], oracle[fin], rtol=2e-4, atol=2e-5)


def test_stack_subgraphs_matches_reference(data):
    gj, _, gt, _ = _leaves(data, 2)
    n_a = gt[0].capacity
    tp.assert_graphs_equal(tmerge.stack_subgraphs(gt[0], gt[1], n_a),
                           jmerge.stack_subgraphs(gj[0], gj[1], n_a), "stack")
    partial = tgraph.grow_graph(gt[1], gt[1].capacity + 8)
    with pytest.raises(ValueError, match="fully-allocated"):
        tmerge.stack_subgraphs(gt[0], partial, n_a)


def test_symmetric_merge_matches_reference_with_dead_rows(data):
    """Both sides churned (rows removed, still fully allocated): the merged
    graph and the comps equal the reference's, and no dead row is listed."""
    gj, _, _, _ = _leaves(data, 2)
    bounds = tconstruct.partition_bounds(N, 2)
    rng = np.random.RandomState(5)
    gj = [jdynamic.remove(g, jnp.asarray(data[bounds[s]:bounds[s + 1]]),
                          jnp.asarray(rng.choice(g.capacity, 20, replace=False).astype(np.int32)),
                          "l2")
          for s, g in enumerate(gj)]
    gt = [tp.to_torch_graph(g) for g in gj]
    key = jax.random.PRNGKey(6)
    want, c_want = jmerge.symmetric_merge(gj[0], gj[1], jnp.asarray(data),
                                          _jcfg().search_config(), key, search_chunk=CHUNK)
    got, c_got = tmerge.symmetric_merge(gt[0], gt[1], torch.from_numpy(data),
                                        _tcfg().search_config(), tp.JaxDraws(key),
                                        search_chunk=CHUNK)
    tp.assert_graphs_equal(got, want, "symmetric_merge")
    assert c_got == int(c_want)
    inv = tgraph.graph_invariants_ok(got)
    assert all(bool(v.all()) for v in inv.values()), inv


def test_symmetric_merge_refuses_before_searching(data, monkeypatch):
    _, _, gt, _ = _leaves(data, 2)
    partial = tgraph.grow_graph(gt[1], gt[1].capacity + 8)
    monkeypatch.setattr(tmerge, "_chunked_cross_search", None)  # must not be reached
    with pytest.raises(ValueError, match="fully-allocated"):
        tmerge.symmetric_merge(gt[0], partial, torch.zeros(N + 8, D), _tcfg().search_config())
    with pytest.raises(ValueError, match="rows"):
        tmerge.symmetric_merge(gt[0], gt[1], torch.zeros(N + 1, D), _tcfg().search_config())


def test_merge_subgraphs_with_coarse_levels_and_fold(data):
    """Coarse-seeded leaves: the cross searches seed from each leaf's level,
    the pair's levels fold (``fold_coarse``), and the root level equals the
    reference's."""
    over = dict(seed_mode="coarse", coarse_landmarks=24)
    gj, cj, gt, ct = _leaves(data, 2, **over)
    key = jax.random.PRNGKey(8)
    want, c_want, lvl_want = jmerge.merge_subgraphs(
        gj, jnp.asarray(data), _jcfg(**over).search_config(), key, search_chunk=CHUNK,
        coarses=cj)
    got, c_got, lvl_got = tmerge.merge_subgraphs(
        gt, torch.from_numpy(data), _tcfg(**over).search_config(), tp.JaxDraws(key),
        search_chunk=CHUNK, coarses=ct)
    tp.assert_graphs_equal(got, want, "coarse tree")
    tp.assert_coarse_equal(lvl_got, lvl_want, "root level")
    assert c_got == int(c_want)


def test_fold_coarse_matches_reference(data):
    over = dict(seed_mode="coarse", coarse_landmarks=24)
    _, cj, _, ct = _leaves(data, 2, **over)
    n_a = int(tconstruct.partition_bounds(N, 2)[1])
    key = jax.random.PRNGKey(9)
    want, c_want = jhier.fold_coarse(cj[0], cj[1], n_a, _jcfg(**over).search_config(), key)
    got, c_got = thier.fold_coarse(ct[0], ct[1], n_a, _tcfg(**over).search_config(),
                                   tp.JaxDraws(key))
    tp.assert_coarse_equal(got, want, "fold")
    assert c_got == int(c_want) > 0
    assert got.landmark_rows.max() >= n_a  # the right block's rows are offset
    assert thier.fold_coarse(None, ct[1], n_a, _tcfg(**over).search_config(),
                             tp.JaxDraws(key)) == (None, 0)


def test_coarse_router_matches_reference(data):
    """A router of coarse-seeded shards (the coarse tree's leaf shapes):
    each shard's search splits its draws for the coarse pass, and
    ``merge_shards`` folds the shard levels into the merged index's level.
    ``test_torch_router.py`` holds the rest of the router."""
    over = dict(seed_mode="coarse", coarse_landmarks=24)
    cfg = {**CFG, **over}
    jr = JRouter.build(jnp.asarray(data), 2, _jcfg(**over), key=jax.random.PRNGKey(14))
    tr = TRouter.build(torch.from_numpy(data), 2, _tcfg(**over), draws=tp.JaxDraws(
        jax.random.PRNGKey(14)), device="cpu")
    q = tp.int_data(8, D, seed=42)
    want = jr.retrieve(jnp.asarray(q), 10, beam=32, key=jax.random.PRNGKey(15))
    got = tr.retrieve(torch.from_numpy(q), 10, beam=32, draws=tp.JaxDraws(jax.random.PRNGKey(15)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    jr.merge_shards(key=jax.random.PRNGKey(16))
    tr.merge_shards(draws=tp.JaxDraws(jax.random.PRNGKey(16)))
    tp.assert_index_equal(tr.shards[0], jr.shards[0], "coarse merge_shards")
    np.testing.assert_array_equal(tr.gids[0], jr.gids[0])
    assert tr.shards[0].coarse is not None and tr.shards[0].build_cfg.seed_mode == cfg["seed_mode"]


def test_mesh_is_refused_naming_item_12(data):
    """Once a refusal, now the mesh branch (Queue A item 12) on one rank: a
    level of one pair merges on a one-rank gloo group, equal bit for bit to
    the reference's mesh path on a one-device mesh (each side searched in
    one batch; ``search_chunk`` is for the levels merged on the host) and
    to ``distributed.merge_pairs_mesh``; a group whose size is not the
    shard count is refused before any sub-build."""
    from repro.kernels import compat
    from repro_torch.core import distributed
    from repro_torch.launch import mesh

    gj, _, gt, _ = _leaves(data, 2)
    x = torch.from_numpy(data)
    scfg = _tcfg().search_config()
    key = jax.random.PRNGKey(3)
    want, c_want, _ = jmerge.merge_subgraphs(gj, jnp.asarray(data), _jcfg().search_config(), key,
                                             mesh=compat.make_mesh((1,), ("data",)))
    grp = mesh.init_group(0, 1, "gloo", mesh.free_port())
    try:
        g, comps, _ = tmerge.merge_subgraphs(gt, x, scfg, tp.JaxDraws(key), mesh=grp)
        tp.assert_graphs_equal(g, want, "mesh merge")
        assert comps == int(c_want)
        own, own_comps = distributed.merge_pairs_mesh(
            grp, [(gt[0], gt[1])], [x], scfg, [tp.JaxDraws(key).fold_in(0)])
        assert own_comps == comps
        tp.assert_graphs_equal(own[0], want, "merge_pairs_mesh")
        with pytest.raises(ValueError, match="one sub-graph per rank"):
            tconstruct.build_parallel(x, _tcfg(), shards=2, mesh=grp, device="cpu")
    finally:
        mesh.close_group()


def test_a_converged_lane_still_moves_when_stepped():
    """Why the mesh's cross searches are not cut into chunks: a lane that
    has converged gets no candidates, yet a step still re-merges its beam,
    and a hole the previous merge's dedupe left (-1, +inf) sorts to the
    end, so how many steps its batch runs after it converged can change its
    top-k.  The port's step does what the reference's does."""
    e, H = 6, 16
    rng = np.random.RandomState(0)
    x = rng.randint(0, 8, (10, D)).astype(np.float32)
    q = x[:1] + 1
    beam_ids = np.array([[2, -1, 5, 7, -1, -1]], np.int32)
    beam_dist = np.array([[1.0, np.inf, 2.0, 3.0, np.inf, np.inf]], np.float32)
    beam_exp = np.ones((1, e), bool)
    cands = np.full((1, 4), -1, np.int32)
    vis_ids = np.full((1, H), -1, np.int32)
    vis_dist = np.full((1, H), np.inf, np.float32)
    args = (q, x, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist)
    got = tops.expand_step(*(torch.from_numpy(a.copy()) for a in args), metric="l2")
    want = jops.expand_step(*(jnp.asarray(a) for a in args), metric="l2")
    assert got[0].tolist() == [[2, 5, 7, -1, -1, -1]]
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    assert got[1].tolist() == np.asarray(want[1]).tolist()
    assert int(got[5].sum()) == int(np.asarray(want[5]).sum()) == 0


def test_torch_draws_are_values():
    """A ``TorchDraws`` reads the same numbers on every call, its children
    differ from it and from each other, and the search and wave helpers
    split it as the reference splits a key (checked against ``JaxDraws``'s
    own split of the same chain)."""
    from repro_torch.core import draws as tdraws

    d = tdraws.TorchDraws(5)
    assert torch.equal(d.randint((4, 3), 100), d.randint((4, 3), 100))
    a, b = d.split()
    kids = [d.randint((64,), 1 << 20), a.randint((64,), 1 << 20), b.randint((64,), 1 << 20),
            d.fold_in(1).randint((64,), 1 << 20)]
    assert all(not torch.equal(kids[i], kids[j]) for i in range(4) for j in range(i))
    assert sorted(d.choice(50, 50).tolist()) == list(range(50))
    key = jax.random.PRNGKey(3)
    seeds, coarse = tdraws.search_entry(tp.JaxDraws(key), 6, 4, 100, n_landmarks=9)
    want_r, want_c = tp.search_entry(key, 6, 4, 100, n_landmarks=9)
    assert torch.equal(seeds, want_r) and torch.equal(coarse, want_c)
    fn_t = tdraws.wave_seed_fn(tp.JaxDraws(key), 4)
    fn_j = tp.build_seed_fn(key, 4)
    for wave in (0, 1, 2):
        assert torch.equal(fn_t(wave, 0, 8, 50 + wave), fn_j(wave, 0, 8, 50 + wave))
