"""The paper's core examples on the port against the reference.

``examples/quickstart_torch.py``'s ``run`` against the reference's stages
of ``examples/quickstart.py`` (re-enacted here at the example's ``--tiny``
size) on the same numpy rows, with the reference's key chains replayed
(``torch_parity``).  Exact tier, on small-integer rows: the graph, coarse
level, counters, search ids and comparisons, ``n_valid`` and ``alive`` are
equal, and so are the recalls computed from them.  Tolerance tier, on the
reference's own clustered rows: the counts that do not depend on the data
are equal and every recall agrees within ``torch_examples.RECALL_TOL``.
The lifecycle and divide-and-conquer examples have files of their own
(``test_torch_example_lifecycle.py``, ``test_torch_example_parallel.py``);
each of the three examples' ``main --device cpu --tiny`` runs here
in-process, so its own asserts are a gate.  The examples import from the
package's facades, which export the reference's names.
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
from repro.core import dynamic as jdynamic
from repro.core import search as jsearch
from repro.core.graph import grow_graph as jgrow
from repro.data import synthetic as jsynth

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


def recall(pred, truth, k):
    return float(jbrute.recall_at_k(pred, truth, k))


def _quickstart_reference(x, q, extra, n_remove):
    n, k = x.shape[0], 10
    cfg = jconstruct.BuildConfig(k=k, metric="l2", wave=256, lgd=True, dispatch="reference",
                                 seed_mode="coarse")
    g, stats, coarse = jconstruct.build(jnp.asarray(x), cfg, jax.random.PRNGKey(0),
                                        return_coarse=True)
    tids, _ = jbrute.brute_force_knn(jnp.asarray(x), jnp.asarray(x), k, "l2",
                                     exclude_ids=jnp.arange(n, dtype=jnp.int32),
                                     use_pallas=False)
    scfg = jsearch.SearchConfig(k=k, beam=40, use_lgd_mask=True, dispatch="reference",
                                seed_mode="coarse")
    res = jsearch.search(g, jnp.asarray(x), jnp.asarray(q), jax.random.PRNGKey(1), scfg,
                         coarse=coarse)
    tq, _ = jbrute.brute_force_knn(jnp.asarray(x), jnp.asarray(q), 1, "l2", use_pallas=False)
    rres = jsearch.search(g, jnp.asarray(x), jnp.asarray(q), jax.random.PRNGKey(1),
                          jsearch.SearchConfig(k=k, beam=40, use_lgd_mask=True,
                                               dispatch="reference"))
    x2 = jnp.concatenate([jnp.asarray(x), jnp.asarray(extra)])
    g2, _, coarse2 = jdynamic.insert(jgrow(g, n + extra.shape[0]), x2, extra.shape[0], cfg,
                                     jax.random.PRNGKey(2), coarse=coarse)
    g3 = jdynamic.remove(g2, x2, jnp.arange(n_remove, dtype=jnp.int32), "l2")
    return {"graph": g, "stats": stats, "coarse": coarse, "result": res, "random_result": rres,
            "inserted": g2, "inserted_coarse": coarse2, "removed": g3,
            "graph_recall": recall(g.nbr_ids, tids, k),
            "recall1": recall(res.ids[:, :1], tq, 1),
            "random_recall1": recall(rres.ids[:, :1], tq, 1)}


@pytest.mark.parametrize("rows", ["integer", "clustered"])
def test_quickstart_matches_reference(rows):
    ex = te.load("quickstart_torch")
    n, nq, m, n_remove = (ex.TINY[f] for f in ("n", "n_queries", "n_extra", "n_remove"))
    if rows == "integer":
        full = tp.int_data(n + nq, ex.D, seed=0)
        extra = tp.int_data(m, ex.D, seed=9)
    else:
        full = np.array(jsynth.clustered(jax.random.PRNGKey(0), n + nq, ex.D))
        extra = np.array(jsynth.clustered(jax.random.PRNGKey(9), m, ex.D))
    x, q = full[:n], full[n:]
    want = _quickstart_reference(x, q, extra, n_remove)
    got = ex.run(x, q, extra, build_draws=tp.draws(0), search_draws=tp.draws(1),
                 insert_draws=tp.draws(2), n_remove=n_remove, device="cpu")
    exact = rows == "integer"
    for name in ("graph_recall", "recall1", "random_recall1"):
        te.close(got[name], want[name], exact, name)
    assert got["n_landmarks"] == int(want["coarse"].n_landmarks)
    assert got["n_valid"] == int(want["inserted"].n_valid) == n + m
    assert got["alive"] == int(want["removed"].alive.sum()) == n + m - n_remove
    np.testing.assert_array_equal(got["removed"].alive.numpy(), np.asarray(want["removed"].alive))
    if not exact:
        return
    assert got["n_comps"] == int(want["stats"].n_comps)
    tp.assert_graphs_equal(got["graph"], want["graph"], "build")
    tp.assert_coarse_equal(got["coarse"], want["coarse"], "build")
    for name in ("result", "random_result"):
        for field in ("ids", "n_comps", "seed_cell"):
            np.testing.assert_array_equal(getattr(got[name], field).numpy(),
                                          np.asarray(getattr(want[name], field)),
                                          err_msg=f"{name} {field}")
    tp.assert_graphs_equal(got["inserted"], want["inserted"], "insert")
    tp.assert_coarse_equal(got["inserted_coarse"], want["inserted_coarse"], "insert")
    tp.assert_graphs_equal(got["removed"], want["removed"], "remove")


# ---------------------------------------------------------------------------
# the examples' own asserts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["quickstart_torch", "lifecycle_torch", "parallel_build_torch"])
def test_example_main_tiny_on_cpu(name, capsys):
    out = te.load(name).main(["--device", "cpu", "--tiny"])
    assert out["device"] == "cpu"
    assert "recall" in capsys.readouterr().out


def test_facade_exports_the_reference_names():
    """``repro_torch`` and ``repro_torch.core`` export every name the
    reference's facades export, each resolving to the port's object of
    that name; the examples import from them."""
    import repro
    import repro.core
    import repro_torch
    import repro_torch.core
    from repro_torch.index import lifecycle, router

    assert set(repro.__all__) == set(repro_torch.__all__)
    assert set(repro.core.__all__) == set(repro_torch.core.__all__)
    for name in repro_torch.__all__:
        assert getattr(repro_torch, name) is not None, name
    assert repro_torch.OnlineIndex is lifecycle.OnlineIndex
    assert repro_torch.ShardedIndex is router.ShardedIndex
    assert repro_torch.core.metrics.names() == repro.core.metrics.names()
    for name in repro.core.__all__:
        assert getattr(repro_torch.core, name) is not None, name
