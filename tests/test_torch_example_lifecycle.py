"""``examples/lifecycle_torch.py``'s ``run`` against the reference's stages
of ``examples/lifecycle.py`` (re-enacted here at the example's ``--tiny``
size) on the same numpy rows, with the reference's key chains and its
churn victims (``RandomState(3)``) replayed.

Exact tier, on small-integer rows: the recalls, the restored replica's
ids, the capacity after churn, ``n_valid`` around the coalesced ingest, the
free ledger, the compaction map and the whole index after it are equal.
Tolerance tier, on Gaussian rows drawn as the reference draws them: the
counts are equal and every recall agrees within
``torch_examples.RECALL_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_examples as te
import torch_parity as tp
from repro.core import brute as jbrute
from repro.index import OnlineIndex as JIndex
from repro.serve import retrieval as jret

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


def recall(pred, truth, k):
    return float(jbrute.recall_at_k(pred, truth, k))


def _lifecycle_reference(items, q, churn_rows, ingest_rows, path):
    def index_recall(idx, k=10):
        true_ids, _ = jbrute.brute_force_knn(idx.items, jnp.asarray(q), k, idx.metric,
                                             n_valid=idx.graph.n_valid, alive=idx.graph.alive)
        res = idx.search(jnp.asarray(q), 2 * k, beam=64, key=jax.random.PRNGKey(5))
        return recall(res.ids, true_ids, k)

    key = jax.random.PRNGKey(0)
    idx = jret.build_index(jnp.asarray(items), k=16, metric="l2", wave=512,
                           key=jax.random.PRNGKey(2))
    out = {"recall_build": index_recall(idx)}
    idx.save(path)
    replica = JIndex.load(path)
    out["retrieved"] = np.asarray(jret.retrieve(idx, jnp.asarray(q[:4]), 10,
                                                key=jax.random.PRNGKey(7))[0])
    rng = np.random.RandomState(3)
    for step, rows in enumerate(churn_rows):
        alive = np.flatnonzero(np.asarray(replica.graph.alive))
        replica.remove(jnp.asarray(rng.choice(alive, rows.shape[0], replace=False)))
        replica.add(jnp.asarray(rows), key=jax.random.fold_in(key, 20 + step), flush=True)
    out["capacity"] = replica.capacity
    out["recall_churn"] = index_recall(replica)
    out["n_before"] = int(replica.graph.n_valid)
    for row in ingest_rows:
        replica.add(jnp.asarray(row[None, :]))
    out["n_after"] = int(replica.graph.n_valid)
    alive = np.flatnonzero(np.asarray(replica.graph.alive))
    replica.remove(jnp.asarray(alive[: len(alive) // 4]))
    out["free_slots"] = replica.free_slots
    out["id_map"] = np.asarray(replica.compact())
    out["recall_compact"] = index_recall(replica)
    out["index"] = replica
    return out


@pytest.mark.parametrize("rows", ["integer", "gaussian"])
def test_lifecycle_matches_reference(rows, tmp_path):
    ex = te.load("lifecycle_torch")
    n, m, batch = ex.TINY["n"], ex.TINY["churn"], 64
    if rows == "integer":
        items, q = tp.int_data(n, ex.D, seed=0), tp.int_data(ex.N_QUERIES, ex.D, seed=1)
        churn = [tp.int_data(m, ex.D, seed=10 + s) for s in range(ex.CHURN_ROUNDS)]
        ingest = tp.int_data(batch, ex.D, seed=100)
    else:
        key = jax.random.PRNGKey(0)
        items = np.array(jax.random.normal(key, (n, ex.D)))
        q = np.array(jax.random.normal(jax.random.PRNGKey(1), (ex.N_QUERIES, ex.D)))
        churn = [np.array(jax.random.normal(jax.random.fold_in(key, 10 + s), (m, ex.D)))
                 for s in range(ex.CHURN_ROUNDS)]
        ingest = np.array(jax.random.normal(jax.random.fold_in(key, 100), (batch, ex.D)))
    want = _lifecycle_reference(items, q, churn, ingest, str(tmp_path / "jax"))
    rng = np.random.RandomState(3)
    got = ex.run(
        items, q, churn, ingest, build_draws=tp.draws(2), recall_draws=tp.draws(5),
        retrieve_draws=tp.draws(7),
        add_draws=[tp.JaxDraws(jax.random.fold_in(jax.random.PRNGKey(0), 20 + s))
                   for s in range(ex.CHURN_ROUNDS)],
        pick=lambda alive, count: rng.choice(alive, count, replace=False),
        # the reference's flush without a key draws from PRNGKey(first new row)
        ingest_draws=tp.draws(want["n_before"]), path=str(tmp_path / "torch"), device="cpu")
    exact = rows == "integer"
    for name in ("recall_build", "recall_churn", "recall_compact"):
        te.close(got[name], want[name], exact, name)
    for name in ("capacity", "n_before", "n_after", "free_slots"):
        assert got[name] == want[name], name
    assert got["capacity"] == n and got["n_after"] == got["n_before"] + batch
    if not exact:
        return
    np.testing.assert_array_equal(got["retrieved"].numpy(), want["retrieved"])
    np.testing.assert_array_equal(got["id_map"], want["id_map"])
    tp.assert_index_equal(got["index"], want["index"], "after compact")


