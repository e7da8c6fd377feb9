"""``examples/parallel_build_torch.py``'s ``run`` against the reference's
stages of ``examples/parallel_build.py`` (re-enacted here at the example's
``--tiny`` size) on the same small-integer rows, with the reference's key
chains replayed: the sequential, parallel, merged and refined graphs, the
parallel build's comparisons, the router's exact and served ids before and
after the collapse, the global ids of the post-merge insert and the catalog
size are equal, and so are the recalls computed from them.

Integer rows only: the reference's eager merge and refine recompile for
every new data set (about 25 s here), and ``build_parallel``'s recall on
Gaussian rows is held within a tolerance by
``test_torch_parallel_build.py::test_build_parallel_gaussian_recall``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_examples as te
import torch_parity as tp
from repro.core import brute as jbrute
from repro.core import construct as jconstruct
from repro.core import merge as jmerge
from repro.core import nndescent as jnnd
from repro.index import ShardedIndex as JRouter
from repro_torch.core import draws as draws_lib

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


def recall(pred, truth, k):
    return float(jbrute.recall_at_k(pred, truth, k))


def _parallel_reference(x, q, new_rows):
    xj = jnp.asarray(x)
    n = x.shape[0]
    cfg = jconstruct.BuildConfig(k=16, metric="l2", wave=256, dispatch="reference")
    tids, _ = jbrute.brute_force_knn(xj, xj, 10, "l2", exclude_ids=jnp.arange(n, dtype=jnp.int32),
                                     use_pallas=False)

    def graph_recall(g):
        return recall(g.nbr_ids[:, :10], tids, 10)

    out = {}
    out["sequential"], _ = jconstruct.build(xj, cfg, jax.random.PRNGKey(1))
    out["parallel"], stats = jconstruct.build_parallel(xj, cfg, jax.random.PRNGKey(1), shards=4,
                                                       refine_rounds=1)
    out["n_comps"] = int(stats.n_comps)
    b = int(jconstruct.partition_bounds(n, 2)[1])
    ga, _ = jconstruct.build(xj[:b], cfg, jax.random.PRNGKey(2))
    gb, _ = jconstruct.build(xj[b:], cfg, jax.random.PRNGKey(3))
    out["merged"], _ = jmerge.symmetric_merge(ga, gb, xj, cfg.search_config(),
                                              jax.random.PRNGKey(4))
    out["refined"], _ = jnnd.refine(out["merged"], xj, "l2", rounds=1)
    for name in ("sequential", "parallel", "merged", "refined"):
        out[f"recall_{name}"] = graph_recall(out[name])
    router = JRouter.build(xj, 4, cfg, key=jax.random.PRNGKey(5))
    out["exact"] = [router.retrieve(xq[None], 10, brute=True)[0] for xq in jnp.asarray(q)]
    router.merge_shards(refine_rounds=1, key=jax.random.PRNGKey(8))
    out["served"] = [router.retrieve(xq[None], 10, beam=64, key=jax.random.PRNGKey(7))[0]
                     for xq in jnp.asarray(q)]
    out["start"] = int(router.shards[0].graph.n_valid)
    out["gids"] = router.add(jnp.asarray(new_rows))
    router.remove(np.asarray(out["gids"][: len(new_rows) // 2]))
    out["n_items"] = router.n_items
    return out


def test_parallel_build_matches_reference():
    ex = te.load("parallel_build_torch")
    n = ex.TINY["n"]
    x, q = tp.int_data(n, ex.D, seed=0), tp.int_data(ex.N_QUERIES, ex.D, seed=6)
    new = tp.int_data(ex.N_ADD, ex.D, seed=9)
    want = _parallel_reference(x, q, new)
    stages = {"build": 1, "half_a": 2, "half_b": 3, "merge": 4, "router": 5, "serve": 7,
              "collapse": 8}
    # the reference's add without a key draws from PRNGKey(first new row)
    got = ex.run(x, q, new, draws={name: tp.draws(seed) for name, seed in stages.items()},
                 add_seed_fn=draws_lib.wave_seed_fn(tp.draws(want["start"]), 8), device="cpu")
    for name in ("sequential", "parallel", "merged", "refined"):
        te.close(got[f"recall_{name}"], want[f"recall_{name}"], True, name)
        tp.assert_graphs_equal(got[name], want[name], name)
    assert got["n_comps"] == want["n_comps"]
    assert got["n_shards"] == 1 and got["n_items"] == want["n_items"]
    np.testing.assert_array_equal(got["gids"], want["gids"])
    for name in ("exact", "served"):
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)
