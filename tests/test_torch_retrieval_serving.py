"""The recommender serving slice as a whole: a MIND encoder's interests
served through the LGD index (``serve.retrieval``, metric ``ip``), port
against the JAX package, and the port's ``examples/retrieval_serving_torch.py``.

The reference's parameters are carried across (``convert``), its MIND
routing logits and its key chains replayed (``torch_parity``).  The item
table is integer-valued and the queries are the interests scaled and
rounded to integers, so every inner product is exact in fp32 and the
indexes, retrieved ids and scores equal the reference's bit for bit; the
interests themselves agree to rtol 1e-5, atol 1e-6.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.models import recsys as jrec
from repro.serve import retrieval as jret
from repro_torch import convert
from repro_torch.models import recsys as trec
from repro_torch.serve import retrieval as tret

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_ITEMS, D, K, SEQ, USERS = 480, 8, 8, 10, 6
TOP_K, BEAM, P = 20, 48, 8


def load_example():
    spec = importlib.util.spec_from_file_location(
        "retrieval_serving_torch", ROOT / "examples" / "retrieval_serving_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def slice_run():
    """Both packages through the whole slice: encoder, index build,
    retrieval per user, churn, retrieval again."""
    cfg = trec.RecsysConfig(name="mind", vocab_per_field=N_ITEMS, embed_dim=D, n_interests=4,
                            capsule_iters=3, mlp=(16,), seq_len=SEQ)
    pj = jax.tree.map(np.asarray, jrec.init_params(jax.random.PRNGKey(0), cfg))
    # an integer-valued item table: exact inner products in both packages
    pj["table"] = tp.int_data(N_ITEMS, D, seed=3, high=5) - 2.0
    pt = convert.recsys_params_from_numpy(pj, cfg)
    pj = jax.tree.map(jnp.asarray, pj)
    hist = np.random.RandomState(4).randint(0, N_ITEMS, (USERS, SEQ)).astype(np.int32)
    hist[:, -2:] = -1  # padded histories
    out = {"interests_t": trec.mind_interests(pt, torch.from_numpy(hist), cfg,
                                              routing_init=tp.mind_routing_init),
           "interests_j": np.asarray(jrec.mind_interests(pj, jnp.asarray(hist), cfg))}
    q = [np.round(i * 4.0).astype(np.float32) for i in (out["interests_t"].numpy(),
                                                         out["interests_j"])]
    out["queries"] = q
    items = np.array(pj["table"])[:N_ITEMS]

    with tp.compiled_reference():
        jidx = jret.build_index(jnp.asarray(items), k=K, metric="ip", wave=64,
                                capacity=N_ITEMS + 64, key=jax.random.PRNGKey(1),
                                dispatch="reference")
    tidx = tret.build_index(torch.from_numpy(items), k=K, metric="ip", wave=64,
                            capacity=N_ITEMS + 64,
                            seed_fn=tp.build_seed_fn(jax.random.PRNGKey(1), P), device="cpu")
    out["built"] = (tidx, jidx)

    def serve(jx, tx):
        res = []
        for u in range(USERS):
            qu = q[1][u]
            want = jret.retrieve(jx, jnp.asarray(qu), TOP_K, beam=BEAM)
            got = tret.retrieve(tx, torch.from_numpy(qu), TOP_K, beam=BEAM,
                                seed_fn=tp.fixed_seed_fn(jax.random.PRNGKey(0), P))
            res.append((got, want, tret.retrieve_brute(tx, torch.from_numpy(qu), TOP_K),
                        jret.retrieve_brute(jx, jnp.asarray(qu), TOP_K)))
        return res

    out["served"] = serve(jidx, tidx)
    fresh = tp.int_data(40, D, seed=5, high=5) - 2.0
    with tp.compiled_reference():
        jidx2 = jret.remove_items(jret.add_items(jidx, jnp.asarray(fresh),
                                                 key=jax.random.PRNGKey(4)),
                                  jnp.arange(30, dtype=jnp.int32))
    tidx2 = tret.remove_items(
        tret.add_items(tidx, torch.from_numpy(fresh),
                       seed_fn=tp.build_seed_fn(jax.random.PRNGKey(4), P)),
        torch.arange(30))
    out["churned"] = (tidx2, jidx2)
    out["served_after"] = serve(jidx2, tidx2)
    return out


def test_interests_agree_with_the_reference(slice_run):
    got, want = slice_run["interests_t"].numpy(), slice_run["interests_j"]
    assert got.shape == (USERS, 4, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the integer queries both packages serve are the same
    np.testing.assert_array_equal(*slice_run["queries"])
    assert np.abs(slice_run["queries"][0]).max() >= 2  # not all zero


@pytest.mark.parametrize("stage", ["built", "churned"])
def test_index_equals_the_reference(slice_run, stage):
    tidx, jidx = slice_run[stage]
    tp.assert_index_equal(tidx, jidx, stage)


@pytest.mark.parametrize("stage", ["served", "served_after"])
def test_retrieved_ids_equal_the_reference(slice_run, stage):
    for (ids, scores), (jids, jscores), (bids, bscores), (jbids, jbscores) in slice_run[stage]:
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(scores.numpy(), np.asarray(jscores))
        np.testing.assert_array_equal(bids.numpy(), np.asarray(jbids))
        np.testing.assert_array_equal(bscores.numpy(), np.asarray(jbscores))
        if stage == "served_after":
            assert not np.isin(ids.numpy(), np.arange(30)).any()
            assert not np.isin(bids.numpy(), np.arange(30)).any()


def test_merge_of_four_interests_keeps_each_items_best_score(slice_run):
    """``score_from_dist`` flips ip distances into scores (higher is better)
    and ``_merge_queries`` keeps one copy of an item, its best over the 4
    interests: the brute answer is the top-20 of max_k q_k·x exactly."""
    tidx, _ = slice_run["built"]
    items = tidx.items.numpy()
    for u, (_, _, (bids, bscores), _) in enumerate(slice_run["served"]):
        best = (slice_run["queries"][1][u] @ items.T).max(axis=0)
        assert len(set(bids.tolist())) == TOP_K
        np.testing.assert_array_equal(bscores.numpy(), best[bids.numpy()])
        assert (bscores[:-1] >= bscores[1:]).all()
        assert float(bscores[-1]) == np.sort(best)[::-1][TOP_K - 1]


def test_example_runs_on_the_cpu(capsys):
    rec = load_example().main(["--device", "cpu", "--n-items", "1500"])
    out = capsys.readouterr().out
    assert "indexed 1500 items (d=16) with online LGD on cpu" in out
    assert "no withdrawn items returned" in out
    assert rec["overlap_mean"] >= 0.9 and len(rec["ids"]) == 16
    assert all(len(ids) == TOP_K for ids in rec["ids_after_churn"])
    # checked before the 10^7-row table is drawn
    with pytest.raises(ValueError, match="exceeds"):
        load_example().main(["--device", "cpu", "--n-items", "20000000", "--full-config"])
