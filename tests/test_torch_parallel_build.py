"""Port merge tree (``merge.merge_subgraphs``) and divide-and-conquer build
(``construct.build_parallel``) against the JAX reference
(``dispatch="reference"``), with the reference's key chains replayed
(``torch_parity.JaxDraws``).

On integer-valued data the merged graphs, comps and stats equal the
reference's bit for bit at S = 2, 3 and 5 blocks (5 carries an odd node at
levels 0 and 1), and S = 1 is the sequential build.  On N(0,1) rows the
parallel build's recall@10 is >= 0.95 and within 0.01 of the reference's,
with canonical λ after the refine.  The tree tests build their leaves as
``build_parallel`` does, so the reference compiles one set of shapes per S
for both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro.core import merge as jmerge
from repro_torch.core import construct as tconstruct
from repro_torch.core import graph as tgraph
from repro_torch.core import merge as tmerge
from repro_torch.core import nndescent as tnnd
from repro_torch.launch import build_graph as tlaunch

torch.set_num_threads(2)

N, D, K = 600, 8, 8
CFG = dict(k=K, metric="l2", wave=64, lgd=True, beam=24, n_seeds=4, hash_slots=512,
           max_iters=32, n_seed_init=64)
CHUNK = 128


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


@pytest.fixture(scope="module")
def data():
    return tp.int_data(N, D, seed=0)


def _jcfg():
    return jconstruct.BuildConfig(dispatch="reference", **CFG)


def _tcfg():
    return tconstruct.BuildConfig(**CFG)


@pytest.mark.parametrize("S", [2, 3, 5])
def test_merge_subgraphs_matches_reference(data, S):
    key = jax.random.PRNGKey(7)
    bounds = tconstruct.partition_bounds(N, S)
    gj = [jconstruct.build(jnp.asarray(data[bounds[s]:bounds[s + 1]]), _jcfg(),
                           jax.random.fold_in(key, s))[0] for s in range(S)]
    gt = [tp.to_torch_graph(g) for g in gj]
    want, c_want, lvl_want = jmerge.merge_subgraphs(gj, jnp.asarray(data), _jcfg().search_config(),
                                                    key, search_chunk=CHUNK)
    got, c_got, lvl_got = tmerge.merge_subgraphs(gt, torch.from_numpy(data),
                                                 _tcfg().search_config(), tp.JaxDraws(key),
                                                 search_chunk=CHUNK)
    tp.assert_graphs_equal(got, want, f"S={S}")
    assert c_got == int(c_want) and lvl_got is None and lvl_want is None


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_build_parallel_matches_reference(data, S):
    key = jax.random.PRNGKey(3)
    g_j, st_j = jconstruct.build_parallel(jnp.asarray(data), _jcfg(), key, shards=S,
                                          refine_rounds=1, search_chunk=CHUNK)
    g_t, st_t = tconstruct.build_parallel(torch.from_numpy(data), _tcfg(), tp.JaxDraws(key),
                                          shards=S, refine_rounds=1, search_chunk=CHUNK,
                                          device="cpu")
    tp.assert_graphs_equal(g_t, g_j, f"S={S}")
    assert int(st_t.n_comps) == int(st_j.n_comps)
    assert int(st_t.n_inserted_edges) == int(st_j.n_inserted_edges)
    assert st_t.n_waves == int(st_j.n_waves)
    if S > 1:  # λ is canonical after the refine
        lam, _ = tnnd.recompute_lambda(g_t.nbr_ids, g_t.nbr_dist, torch.from_numpy(data), "l2")
        assert torch.equal(lam, g_t.nbr_lam)


def test_build_parallel_gaussian_recall(data):
    x = tp.gauss_data(N, D, seed=2)
    key = jax.random.PRNGKey(4)
    g_j, _ = jconstruct.build_parallel(jnp.asarray(x), _jcfg(), key, shards=3,
                                       refine_rounds=1, search_chunk=CHUNK)
    g_t, st_t = tconstruct.build_parallel(torch.from_numpy(x), _tcfg(), tp.JaxDraws(key),
                                          shards=3, refine_rounds=1, search_chunk=CHUNK,
                                          device="cpu")
    # recall@K: the graphs hold K < 10 neighbours
    truth, _ = tconstruct.brute.brute_force_knn(
        torch.from_numpy(x), torch.from_numpy(x), K, exclude_ids=torch.arange(N, dtype=torch.int32),
        device="cpu")
    r_t = tconstruct.brute.recall_at_k(g_t.nbr_ids, truth, K)
    r_j = tconstruct.brute.recall_at_k(torch.from_numpy(np.array(g_j.nbr_ids)), truth, K)
    assert r_t >= 0.95 and abs(r_t - r_j) <= 0.01, (r_t, r_j)
    assert all(bool(v.all()) for v in tgraph.graph_invariants_ok(g_t).values())
    lam, _ = tnnd.recompute_lambda(g_t.nbr_ids, g_t.nbr_dist, torch.from_numpy(x), "l2")
    assert torch.equal(lam, g_t.nbr_lam)


def test_launcher_parallel_build_on_cpu(capsys):
    tlaunch.main(["--n", "700", "--d", "8", "--k", "8", "--wave", "128", "--eval-sample", "100",
                  "--parallel-shards", "2", "--refine-rounds", "1", "--search-chunk", "256",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "graph on cpu (2-shard parallel)" in out and "graph recall@8" in out
    with pytest.raises(SystemExit, match="sequential-build"):
        tlaunch.main(["--parallel-shards", "2", "--resume", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--ckpt"):
        tlaunch.main(["--resume", "--device", "cpu"])
