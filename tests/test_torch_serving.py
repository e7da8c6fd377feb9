"""Port serving: ``serve.loop.ServingLoop``, ``serve.retrieval`` and the
``launch.serve`` launcher, against the JAX reference where it decides.

Exact tier, on integer data with the reference's keys replayed: a scripted
loop (bursts, a buffered keyed add, a removal, padded waves) serves the
same ids, folds the same stats and audits the same recall as
``repro.serve.loop.ServingLoop`` (``dispatch="reference"``).  The reference
misses its own floor in ``test_audit_recall_high_on_tiny_catalog`` (0.825
against 0.85); that scenario is held to equality with the reference here.
The rest are the semantics of ``tests/test_serving_loop.py`` and
``tests/test_serve.py`` on the port alone, and ``add_items`` and
``remove_items`` leaving their argument untouched.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.serve.loop import ServeLoopConfig as JLoopConfig
from repro.serve.loop import ServingLoop as JLoop
from repro_torch.core import construct
from repro_torch.index import OnlineIndex
from repro_torch.launch import serve as serve_launch
from repro_torch.obs import InMemoryTracker, load_events
from repro_torch.serve import retrieval
from repro_torch.serve.loop import ServeLoopConfig, ServingLoop, _slice_result

torch.set_num_threads(2)

D = 8
CFG = dict(k=6, wave=64, n_seeds=8)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


def _items(n=192, seed=0):
    return np.random.RandomState(seed).rand(n, D).astype(np.float32)


def _queries(m, seed=100):
    return np.random.RandomState(seed).rand(m, D).astype(np.float32)


def _mk_index(n=192, seed=0):
    return OnlineIndex.build(torch.from_numpy(_items(n, seed)), construct.BuildConfig(**CFG),
                             generator=torch.Generator().manual_seed(1), device="cpu")


def _mk_loop(index=None, **cfg_kw):
    return ServingLoop(index or _mk_index(), ServeLoopConfig(top_k=5, **cfg_kw))


def _loops(n, cfg_kw, seed=3):
    """Both packages' loops over the same integer catalog."""
    x = tp.int_data(n, D, seed=1)
    jidx, tidx = tp.online_index_both(x, dict(CFG, lgd=True), seed=1)
    jloop = JLoop(jidx, JLoopConfig(**cfg_kw), seed=seed)
    tloop = ServingLoop(tidx, ServeLoopConfig(**cfg_kw),
                        seed_fn=tp.search_seed_fn(jax.random.PRNGKey(seed), CFG["n_seeds"]))
    return jloop, tloop


def _assert_loops_equal(tloop, jloop):
    assert tloop.served == jloop.served
    assert len(tloop._res_ids) == len(jloop._res_ids)
    for a, b in zip(tloop._res_ids + tloop._res_q, jloop._res_ids + jloop._res_q):
        np.testing.assert_array_equal(a, np.asarray(b))
    for name in ("n_queries", "total_comps", "total_iters", "hash_full_queries",
                 "capped_queries", "max_comps", "_n_items_weighted"):
        assert getattr(tloop.stats, name) == getattr(jloop.stats, name), name


def _assert_audits_equal(got, want, n):
    """The same audit: the reference reads its recall as a float32 ratio of
    the same hit count."""
    assert got["n_audited"] == want["n_audited"] == n
    for name in ("recall_at_5", "recall_at_5_served"):
        assert np.float32(got[name]) == np.float32(want[name]), name


def test_loop_matches_reference():
    cfg_kw = dict(top_k=5, max_batch=8, recall_sample_every=1, recall_reservoir=64)
    jloop, tloop = _loops(192, cfg_kw)
    bursts = [tp.int_data(m, D, seed=10 + m) for m in (5, 3, 8, 1)]
    add = tp.int_data(4, D, seed=30)
    buckets = []
    for loop, torch_side in ((jloop, False), (tloop, True)):
        out = []
        loop.submit(bursts[0])
        out.append(loop.step()["bucket"])
        key = jax.random.PRNGKey(9)
        if torch_side:
            loop.add(torch.from_numpy(add), seed_fn=tp.build_seed_fn(key, CFG["n_seeds"]))
            loop.remove(torch.tensor([0, 17]))
        else:
            loop.add(jnp.asarray(add), key=key)
            loop.remove(jnp.asarray([0, 17]))
        for b in bursts[1:]:
            loop.submit(b)
        while loop.queue_depth:
            out.append(loop.step()["bucket"])
        buckets.append(out)
    assert buckets[0] == buckets[1] == [8, 8, 4]
    tp.assert_index_equal(tloop.index, jloop.index)
    _assert_loops_equal(tloop, jloop)
    _assert_audits_equal(tloop.audit_recall(k=5), jloop.audit_recall(k=5), 17)


def test_tiny_catalog_audit_equals_reference():
    """``test_serving_loop.py::test_audit_recall_high_on_tiny_catalog``'s
    scenario (48 rows, beam 48, every query audited): the port's audit
    equals the reference's, whatever the reference reads."""
    cfg_kw = dict(top_k=5, beam=48, max_batch=8, recall_sample_every=1)
    jloop, tloop = _loops(48, cfg_kw)
    q = tp.int_data(8, D, seed=100)
    for loop in (jloop, tloop):
        loop.submit(q)
        loop.pump()
    _assert_loops_equal(tloop, jloop)
    got = tloop.audit_recall(k=5)
    _assert_audits_equal(got, jloop.audit_recall(k=5), 8)
    assert 0.0 < got["recall_at_5"] <= 1.0


def test_pow2_bucketing_and_drain_order():
    loop = _mk_loop(max_batch=8)
    assert loop.submit(_queries(5)) == 5
    assert loop.submit(torch.from_numpy(_queries(6, seed=101))) == 11
    assert (lambda w: (w["batch"], w["bucket"]))(loop.step()) == (8, 8)
    assert (lambda w: (w["batch"], w["bucket"]))(loop.step()) == (3, 4)
    assert loop.step() is None
    assert loop.served == 11 and loop.queue_depth == 0


@pytest.mark.parametrize("m,bucket", [(1, 1), (2, 2), (3, 4), (4, 4), (7, 8)])
def test_bucket_is_next_pow2(m, bucket):
    loop = _mk_loop(max_batch=8)
    loop.submit(_queries(m))
    assert loop.step()["bucket"] == bucket


def test_single_submit_and_pump():
    loop = _mk_loop(max_batch=4)
    loop.submit(_queries(1)[0])  # 1-D submit is one row
    w = loop.step()
    assert (w["batch"], w["bucket"]) == (1, 1) and loop.served == 1
    loop.submit(_queries(11))
    assert loop.pump() == 3
    assert loop.served == 12 and loop.stats.n_queries == 12  # padding not counted


def test_churn_between_waves():
    """A buffered add lands at the next wave boundary and is found there; a
    removal lands at once and is never served; served ids are alive."""
    idx = _mk_index()
    loop = ServingLoop(idx, ServeLoopConfig(top_k=5, beam=32, max_batch=8,
                                            recall_sample_every=1))
    n0 = idx.n_items
    probe = _queries(1, seed=777)
    loop.add(probe)
    assert idx.n_pending == 1 and idx.graph.n_valid == n0
    loop.remove(torch.tensor([3, 40, 77]))
    assert idx.n_pending == 0 and idx.n_items == n0 + 1 - 3  # remove flushed first
    loop.submit(probe)
    loop.submit(_queries(16))
    loop.pump()
    assert n0 in loop._res_ids[0]  # the inserted row is its own neighbour
    alive = idx.graph.alive.numpy()
    for ids in loop._res_ids:
        assert not np.isin(ids, [3, 40, 77]).any()
        assert (ids >= 0).all() and alive[ids].all()


def test_reservoir_stride_and_round_robin():
    loop = _mk_loop(max_batch=8, recall_sample_every=2, recall_reservoir=3)
    q = _queries(10)
    loop.submit(q)
    loop.pump()
    assert len(loop._res_q) == 3
    for slot, arrival in enumerate((6, 8, 4)):
        np.testing.assert_array_equal(loop._res_q[slot], q[arrival])
    assert _mk_loop(max_batch=4).audit_recall() == {"n_audited": 0}


def test_report_surface_reset_window_and_queueing():
    idx = _mk_index()
    loop = ServingLoop(idx, ServeLoopConfig(top_k=5, max_batch=8))
    loop.submit(_queries(12))
    loop.pump()
    rec = loop.report(audit_k=5)
    for k in ("n_served", "n_waves", "qps", "p50_latency_ms", "p99_latency_ms",
              "mean_latency_ms", "comps_per_query", "scanning_rate", "hash_saturation_ratio",
              "capped_ratio", "recall_at_5", "recall_at_5_served"):
        assert k in rec, k
    assert rec["n_served"] == 12 and rec["n_waves"] == 2
    assert rec["qps"] > 0 and rec["p99_latency_ms"] >= rec["p50_latency_ms"]
    assert rec["comps_per_query"] > 0 and 0.0 < rec["scanning_rate"] < 1.0
    loop.reset_window()
    assert loop.served == 0 and loop.stats.n_queries == 0 and loop._res_q == []
    assert idx.n_items == 192
    loop.submit(_queries(2))
    time.sleep(0.05)  # the queries wait in the queue before their wave
    loop.step()
    assert loop.report()["p50_latency_ms"] >= 50.0


def test_tracker_sees_the_wave_skeleton():
    trk = InMemoryTracker()
    idx = _mk_index()
    loop = ServingLoop(idx, ServeLoopConfig(top_k=5, max_batch=8), tracker=trk)
    assert idx.tracker is trk
    loop.submit(_queries(9))
    loop.pump()
    searches = trk.spans("serve/search")
    assert len(trk.spans("serve/step")) == len(searches) == 2
    assert all(s["synced"] and s["parent"] == "serve/step" for s in searches)
    per_wave = [e for e in trk.metrics_events if "serve/batch" in e["metrics"]]
    assert [e["metrics"]["serve/bucket"] for e in per_wave] == [8, 1]
    assert [e["step"] for e in per_wave] == [1, 2]


def test_slice_result_and_config_validation():
    res = _mk_index().search(torch.from_numpy(_queries(4)), 5)
    cut = _slice_result(res, 2)
    for f in res._fields:
        assert getattr(cut, f).shape[0] == 2, f
    with pytest.raises(ValueError):
        ServeLoopConfig(max_batch=6)
    with pytest.raises(ValueError):
        ServeLoopConfig(recall_sample_every=0)


@pytest.fixture(scope="module")
def bank():
    x = np.random.RandomState(0).randn(400, 16).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


@pytest.fixture(scope="module")
def index(bank):
    return retrieval.build_index(bank, k=10, wave=128, generator=torch.Generator().manual_seed(1),
                                 device="cpu")


def test_retrieve_against_brute(index, bank):
    q = bank[:4] + 0.05
    ids, scores = retrieval.retrieve(index, q, 10, beam=32)
    bids, bscores = retrieval.retrieve_brute(index, q, 10)
    assert len(set(ids.tolist()) & set(bids.tolist())) >= 7
    assert len(set(ids.tolist())) == 10  # no duplicates across the queries
    assert (scores[:-1] >= scores[1:]).all()  # ip: higher is better
    ids, scores, res = retrieval.retrieve(index, q, 10, with_stats=True)
    assert res.n_comps.shape == (4,)
    assert torch.equal(retrieval.score_from_dist(torch.tensor([1.0]), "l2"), torch.tensor([1.0]))
    assert torch.equal(retrieval.score_from_dist(torch.tensor([1.0]), "cosine"),
                       torch.tensor([-1.0]))


def _snapshot_fields(idx):
    return [f.clone() if isinstance(f, torch.Tensor) else f for f in idx.graph] + [
        idx.items.clone(), idx.free_ids, idx.capacity]


def _assert_unchanged(idx, before):
    for a, b in zip(_snapshot_fields(idx), before):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_add_and_remove_items_leave_their_argument_untouched(index, bank):
    """Copy-on-write: the clone shares tensors with its argument until it
    replaces them, and never writes into one."""
    before = _snapshot_fields(index)
    new = torch.from_numpy(np.random.RandomState(9).randn(64, 16).astype(np.float32))
    grown = retrieval.add_items(index, new)
    _assert_unchanged(index, before)
    assert grown.capacity == 2 * index.capacity and grown.graph.n_valid == 464
    ids, _ = retrieval.retrieve(grown, new[:4], 5, beam=32)
    assert set(ids.tolist()) & set(range(400, 464))
    shrunk = retrieval.remove_items(index, torch.arange(0, 30))
    _assert_unchanged(index, before)
    assert shrunk.free_slots == 30 and index.free_slots == 0
    ids, _ = retrieval.retrieve(shrunk, bank[:8], 10)
    assert not np.isin(ids.numpy(), np.arange(30)).any()
    both = retrieval.add_items(shrunk, new[:8])  # compacts into the freed rows
    assert both.capacity == 400 and both.graph.n_valid == 378
    assert shrunk.graph.n_valid == 400 and shrunk.free_slots == 30


def test_launcher_runs_on_cpu(tmp_path, capsys):
    rec = serve_launch.main(["--n-items", "600", "--d", "8", "--requests", "4", "--device",
                             "cpu", "--snapshot", str(tmp_path / "snap"), "--trace",
                             str(tmp_path / "t.jsonl")])
    out = capsys.readouterr().out
    assert "indexed 600 items on cpu" in out and "snapshot round trip" in out
    assert rec["n_served"] == 8 and (tmp_path / "t.jsonl").exists()
    rec = serve_launch.main(["--n-items", "600", "--d", "8", "--requests", "4", "--device", "cpu",
                             "--shards", "2", "--snapshot", str(tmp_path / "router"), "--trace",
                             str(tmp_path / "router.jsonl")])
    out = capsys.readouterr().out
    assert "over 2 shards on cpu" in out and "snapshot round trip" in out
    assert rec["n_served"] == 16 and rec["p99_latency_ms"] >= rec["p50_latency_ms"] > 0
    spans = {e["name"] for e in load_events(str(tmp_path / "router.jsonl")) if e.get("event") == "span"}
    assert {"router/shard0", "router/shard1"} <= spans
    rec = serve_launch.main(["--mode", "lm", "--device", "cpu", "--gen", "4"])
    assert "gemma3-1b on cpu: prefill 32 + decode 4 tokens x 4" in capsys.readouterr().out
    assert tuple(rec["tokens"].shape) == (4, 4) and rec["tok_s"] > 0


def test_lm_launcher_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_launch.main(["--mode", "lm", "--arch", "gemma3-1b"])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b", "stablelm-1.6b", "qwen2.5-3b",
                                  "gemma3-1b"])
def test_lm_launcher_serves_on_cpu(arch, capsys):
    """``--mode lm`` on each LM's smoke config: prefill, then greedy decode
    steps on the padded cache; the tokens are in the vocabulary and the
    same on a second run (every draw is seeded)."""
    from repro_torch import configs as tconfigs

    argv = ["--mode", "lm", "--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "20", "--gen", "6"]
    rec = serve_launch.main(argv)
    assert f"{arch} on cpu: prefill 20 + decode 6 tokens x 2" in capsys.readouterr().out
    toks = rec["tokens"]
    assert tuple(toks.shape) == (2, 6) and toks.dtype == torch.int32
    vocab = tconfigs.get(arch).smoke_config().vocab
    assert bool(((toks >= 0) & (toks < vocab)).all())
    assert torch.equal(serve_launch.main(argv)["tokens"], toks)


def test_new_entry_points_raise_without_a_card(monkeypatch, tmp_path, index):
    """Like the build and search entry points, the index's, the snapshot
    reader's and the launcher's run on the card unless given the CPU."""
    from repro_torch.core import dynamic, hierarchy
    from repro_torch.index import snapshot

    path = index.save(str(tmp_path / "snap"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.rand(300, 4)
    for call in (
        lambda: OnlineIndex.build(x, construct.BuildConfig(k=4, wave=32)),
        lambda: OnlineIndex.load(path),
        lambda: snapshot.load(path),
        lambda: retrieval.build_index(x),
        lambda: dynamic.insert(index.graph, index.items, 1, index.build_cfg),
        lambda: hierarchy.derive_coarse(index.graph, index.items, index.build_cfg),
        lambda: serve_launch.main(["--n-items", "300", "--d", "4"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
