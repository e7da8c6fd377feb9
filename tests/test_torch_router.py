"""Port ``ShardedIndex`` (``index.router``) against the JAX reference's
(``dispatch="reference"``): build, churn (add routed to the least-filled
shard, remove routed by ownership, compact), graph and brute retrieval,
``merge_shards`` and snapshots, on the same integer data with the
reference's keys replayed (``torch_parity.JaxDraws`` and ``build_seed_fn``).
Every shard, id table and answer is bit-identical, and a router saved by
either package loads in the other.

``tests/test_lifecycle.py::TestShardedRouter::test_brute_merge_matches_single_index_exactly``
fails in the reference: its sharded brute distances differ from the
unsharded ones in the last bits.  On its inputs the port is held to the
reference's own sharded answer instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro.index import ShardedIndex as JRouter
from repro_torch.core import construct as tconstruct
from repro_torch.index import OnlineIndex as TIndex
from repro_torch.index import ShardedIndex as TRouter
from repro_torch.obs import InMemoryTracker
from repro_torch.serve import retrieval as tretrieval

torch.set_num_threads(2)

N, D, K, P = 600, 8, 8, 4
CFG = dict(k=K, metric="l2", wave=128, lgd=True, beam=24, n_seeds=P, hash_slots=512,
           max_iters=32)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


@pytest.fixture(scope="module")
def data():
    return tp.int_data(N, D, seed=0)


@pytest.fixture(scope="module")
def queries():
    return tp.int_data(8, D, seed=42)


def _build_both(x, S=3, seed=4, **over):
    cfg = {**CFG, **over}
    jr = JRouter.build(jnp.asarray(x), S, jconstruct.BuildConfig(dispatch="reference", **cfg),
                       key=jax.random.PRNGKey(seed))
    tr = TRouter.build(torch.from_numpy(x), S, tconstruct.BuildConfig(**cfg),
                       draws=tp.draws(seed), device="cpu")
    return jr, tr


def _assert_router_equal(tr, jr, err=""):
    assert tr.n_shards == jr.n_shards and tr.next_gid == jr.next_gid, err
    for a, b in zip(tr.shards, jr.shards):
        tp.assert_index_equal(a, b, err)
    for a, b in zip(tr.gids, jr.gids):
        np.testing.assert_array_equal(a, b, err_msg=err)


def _retrieve_both(jr, tr, q, seed=None, brute=False):
    kw = dict(brute=True) if brute else dict(beam=32)
    want = jr.retrieve(jnp.asarray(q), 10, key=None if brute else jax.random.PRNGKey(seed), **kw)
    got = tr.retrieve(torch.from_numpy(q), 10, draws=None if brute else tp.draws(seed), **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    return got


def _add_both(jr, tr, rows, seed):
    key = jax.random.PRNGKey(seed)
    s = int(np.argmin([sh.n_items for sh in tr.shards]))
    want = jr.add(jnp.asarray(rows), key=key)
    got = tr.add(torch.from_numpy(rows), seed_fn=tp.build_seed_fn(key, P, tp.n_landmarks(tr.shards[s])))
    np.testing.assert_array_equal(got, want)
    return got


@pytest.fixture(scope="module")
def churned(data, queries):
    """Both routers after add -> remove (with the -1 sentinel) -> compact."""
    jr, tr = _build_both(data, S=2)
    _assert_router_equal(tr, jr, "build")
    _retrieve_both(jr, tr, queries, seed=9)
    new = tp.int_data(40, D, seed=5)
    gids = _add_both(jr, tr, new, 5)
    assert gids.tolist() == list(range(N, N + 40))
    _assert_router_equal(tr, jr, "add")
    victims = np.concatenate([np.random.RandomState(3).choice(N + 40, 100, replace=False), [-1]])
    assert tr.remove(victims) == jr.remove(victims) == 100
    _assert_router_equal(tr, jr, "remove")
    jr.compact()
    tr.compact()
    _assert_router_equal(tr, jr, "compact")
    return jr, tr, victims


def test_build_churn_and_retrieve_match_reference(churned, queries):
    jr, tr, victims = churned
    assert all(sh.free_slots == 0 for sh in tr.shards) and tr.n_items == N + 40 - 100
    for seed in (9, 10):
        ids, _ = _retrieve_both(jr, tr, queries, seed=seed)
        assert not np.isin(ids, victims[victims >= 0]).any()
    ids, _ = _retrieve_both(jr, tr, queries, brute=True)
    assert not np.isin(ids, victims[victims >= 0]).any()


def test_retrieve_spans_and_stats(churned, queries):
    _, tr, _ = churned
    trk = InMemoryTracker()
    tr.tracker = trk
    try:
        ids, _, stats = tr.retrieve(torch.from_numpy(queries), 10, beam=32, with_stats=True)
    finally:
        tr.tracker = None
    assert [s["name"] for s in trk.span_events] == ["router/shard0", "router/shard1"]
    assert stats.n_queries == 2 * len(queries) and stats.comps_per_query > 0
    assert tr.retrieve(torch.from_numpy(queries), 10, brute=True, with_stats=True)[2] is None


def test_mutations_replace_the_id_tables(data):
    _, tr = _build_both(data, S=2)
    held = [t for t in tr.gids]
    before = [t.copy() for t in held]
    tr.remove(np.arange(0, 600, 7))
    tr.compact()
    for a, b in zip(held, before):
        np.testing.assert_array_equal(a, b)
    assert tr.remove(np.asarray([-1])) == 0


def test_snapshots_load_across_packages(churned, queries, tmp_path):
    jr, tr, _ = churned
    tr.save(str(tmp_path / "port"))
    jr.save(str(tmp_path / "ref"))
    from_port = JRouter.load(str(tmp_path / "port"))
    from_ref = TRouter.load(str(tmp_path / "ref"), device="cpu")
    _assert_router_equal(from_ref, jr, "port loads the reference's")
    _assert_router_equal(tr, from_port, "the reference loads the port's")
    _retrieve_both(from_port, from_ref, queries, seed=11)
    a = tr.retrieve(torch.from_numpy(queries), 10, beam=32, draws=tp.draws(11))
    b = from_ref.retrieve(torch.from_numpy(queries), 10, beam=32, draws=tp.draws(11))
    np.testing.assert_array_equal(a[0], b[0])


def test_merge_shards_matches_reference(churned, queries):
    jr, tr, victims = churned
    jr2 = JRouter(list(jr.shards), list(jr.gids), jr.next_gid)
    tr2 = TRouter(list(tr.shards), list(tr.gids), tr.next_gid)
    jr2.merge_shards(refine_rounds=1, key=jax.random.PRNGKey(12))
    tr2.merge_shards(refine_rounds=1, draws=tp.draws(12))
    _assert_router_equal(tr2, jr2, "merge_shards")
    assert tr2.n_shards == 1 and tr2.n_items == tr.n_items
    # every live global id still resolves: brute force over the merged
    # index finds each row for itself, under its global id
    merged = tr2.shards[0]
    live = tr2.gids[0]
    ids, _ = tretrieval.retrieve_brute(merged, merged.items[:5], 1)
    assert set(live[ids.numpy()].tolist()) <= set(live[:5].tolist())
    assert not np.isin(live, victims[victims >= 0]).any()
    _retrieve_both(jr2, tr2, queries, seed=13)


def test_reference_failing_brute_inputs():
    """The inputs of the reference's failing router test: 600 uniform rows,
    3 shards keyed by PRNGKey(4), 4-query batches.  The port's sharded
    brute ids equal the reference's (and the unsharded ids), its distances
    equal the reference's to the fp32 tolerance of ``tests/test_precision.py``
    (the two packages' products round differently in the last bits), and,
    unlike the reference's, they equal the unsharded distances bit for
    bit: the port's plain product of a query with a row does not depend on
    how many rows share the call."""
    rng = np.random.RandomState(0)
    x = rng.rand(600, 8).astype(np.float32)
    q = np.random.RandomState(42).rand(32, 8).astype(np.float32)
    jr = JRouter.build(jnp.asarray(x), 3, jconstruct.BuildConfig(dispatch="reference", **CFG),
                       key=jax.random.PRNGKey(4))
    tr = TRouter.build(torch.from_numpy(x), 3, tconstruct.BuildConfig(**CFG),
                       draws=tp.draws(4), device="cpu")
    single = TIndex.build(torch.from_numpy(x), tconstruct.BuildConfig(**CFG),
                          seed_fn=tp.build_seed_fn(jax.random.PRNGKey(1), P), device="cpu")
    for i in range(0, 32, 8):
        want = jr.retrieve(jnp.asarray(q[i:i + 4]), 10, brute=True)
        got = tr.retrieve(torch.from_numpy(q[i:i + 4]), 10, brute=True)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=2e-4, atol=2e-5)
        sids, ssc = tretrieval.retrieve_brute(single, torch.from_numpy(q[i:i + 4]), 10)
        np.testing.assert_array_equal(got[0], sids.numpy())
        np.testing.assert_array_equal(got[1], ssc.numpy())
