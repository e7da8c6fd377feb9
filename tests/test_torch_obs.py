"""Port telemetry (``repro_torch.obs``): the span machinery (ids, and the
profiler range each real span holds), the JSONL log, ``SearchStats``
(value-equal to the reference's on the same inputs), and results unchanged
by a tracker: builds, searches and the serving loop give the same bits with
telemetry on and off, and neither ``NoopTracker`` nor the search's and the
exact tiles' spans wait for the card."""

import json

import numpy as np
import pytest
import torch

from repro.obs import SearchStats as JSearchStats
from repro_torch.core import brute, construct
from repro_torch.index import OnlineIndex
from repro_torch.obs import (
    NOOP,
    InMemoryTracker,
    JsonlTracker,
    NoopTracker,
    SearchStats,
    load_events,
    tracker as tracker_lib,
)
from repro_torch.serve.loop import ServeLoopConfig, ServingLoop

torch.set_num_threads(2)


@pytest.fixture
def no_sync(monkeypatch):
    """``torch.cuda.synchronize`` that fails the test if called."""
    def sync(*a, **k):
        raise AssertionError("synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", sync)


def test_span_nesting_depth_parent_and_order():
    trk = InMemoryTracker()
    with trk.span("outer"):
        with trk.span("inner") as sp:
            sp.synced = True
        with trk.span("inner2"):
            pass
    spans = trk.span_events
    assert [e["name"] for e in spans] == ["inner", "inner2", "outer"]
    by_name = {e["name"]: e for e in spans}
    assert by_name["outer"]["depth"] == 0 and "parent" not in by_name["outer"]
    assert by_name["inner"]["depth"] == 1 and by_name["inner"]["parent"] == "outer"
    assert by_name["inner"]["synced"] is True and by_name["inner2"]["synced"] is False
    assert by_name["outer"]["dur_s"] >= by_name["inner"]["dur_s"] >= 0.0


def test_span_sync_waits_for_the_card_only_with_cuda_tensors(no_sync, monkeypatch):
    trk = InMemoryTracker()
    x = torch.arange(4.0)
    with trk.span("s") as sp:
        out = sp.sync({"a": x, "b": (x, [x])})
    assert out["a"] is x  # passthrough
    assert trk.spans("s")[0]["synced"] is True
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: calls.append(1))
    monkeypatch.setattr(tracker_lib, "_holds_cuda", lambda tree: True)
    with trk.span("t") as sp:
        sp.sync(x)
    assert calls == [1]


def test_metrics_carry_step_span_and_host_scalars():
    trk = InMemoryTracker()
    with trk.span("wave"):
        trk.log_metrics({"a": 1, "b": 2.5}, step=7)
    trk.log_metrics({"c": np.int64(3), "t": torch.tensor(4)})
    evs = trk.metrics_events
    assert evs[0]["span"] == "wave" and evs[0]["step"] == 7
    assert evs[0]["metrics"] == {"a": 1, "b": 2.5}
    assert "span" not in evs[1] and evs[1]["metrics"] == {"c": 3, "t": 4}
    assert isinstance(evs[1]["metrics"]["t"], int)


def test_span_stack_unwinds_on_exception():
    trk = InMemoryTracker()
    with pytest.raises(RuntimeError):
        with trk.span("boom"):
            raise RuntimeError("x")
    assert [e["name"] for e in trk.span_events] == ["boom"]
    trk.log_metrics({"after": 1})
    assert "span" not in trk.metrics_events[-1]


def test_noop_tracker_is_inert_and_never_waits(no_sync):
    trk = NoopTracker()
    assert trk.span("a") is trk.span("b")  # one shared context, no allocation
    x = torch.arange(3.0)
    with trk.span("a") as sp:
        assert sp.sync(x) is x
        sp.synced = True  # discarded
        assert sp.synced is False
    trk.log_metrics({"k": 1}, step=0)
    trk.finish()
    assert isinstance(NOOP, NoopTracker)


def test_jsonl_round_trip_and_header(tmp_path):
    p = str(tmp_path / "trace.jsonl")
    trk = JsonlTracker(p, run_meta={"bench": "unit", "n": 8})
    with trk.span("outer"):
        trk.log_metrics({"x": 1.5}, step=0)
    trk.finish()
    evs = load_events(p)
    assert [e["event"] for e in evs] == ["run", "metrics", "span"]
    head = evs[0]
    assert head["meta"] == {"bench": "unit", "n": 8}
    assert head["torch_version"] == torch.__version__
    assert head["cuda_version"] == torch.version.cuda and "device_name" in head
    assert "jax_version" not in head and "wall_time_utc" in head and "pid" in head
    assert evs[1]["metrics"] == {"x": 1.5} and evs[1]["span"] == "outer"
    assert evs[2]["name"] == "outer" and evs[2]["depth"] == 0


def test_jsonl_crash_safety(tmp_path):
    """An event outside every span on disk at once, a span tree's events on
    disk in emission order once its depth-0 span closes, appended across
    runs, a torn tail skipped, a late emit dropped, every line one JSON
    object."""
    p = str(tmp_path / "live.jsonl")
    trk = JsonlTracker(p, run_meta={"run": 0})
    trk.log_metrics({"early": 1})
    assert [e["event"] for e in load_events(p)] == ["run", "metrics"]
    with trk.span("root"):
        with trk.span("child"):
            trk.log_metrics({"inner": 1})
        assert len(load_events(p)) == 2
    assert [(e["event"], e.get("name")) for e in load_events(p)[2:]] == [
        ("metrics", None), ("span", "child"), ("span", "root")]
    trk.finish()
    trk.log_metrics({"late": 1})
    trk = JsonlTracker(p, run_meta={"run": 1})
    with trk.span("a"):
        pass
    trk.finish()
    with open(p, "a", encoding="utf-8") as f:
        f.write('{"event": "metrics", "metrics": {"to')
    evs = load_events(p)
    assert [e["event"] for e in evs] == ["run", "metrics", "metrics", "span", "span", "run", "span"]
    assert [e["meta"]["run"] for e in evs if e["event"] == "run"] == [0, 1]
    with open(p, encoding="utf-8") as f:
        lines = f.read().splitlines()[:-1]
    assert all(isinstance(json.loads(line), dict) for line in lines)


def test_jsonl_writes_a_raising_tree_and_an_open_tree_on_finish(tmp_path):
    """A tree whose body raises is written when its root unwinds; ``finish``
    inside an open span writes what that tree emitted so far."""
    p = str(tmp_path / "unwind.jsonl")
    trk = JsonlTracker(p)
    with pytest.raises(RuntimeError):
        with trk.span("boom"):
            with trk.span("inner"):
                raise RuntimeError("x")
    assert [e.get("name") for e in load_events(p)] == [None, "inner", "boom"]
    with trk.span("open"):
        with trk.span("done"):
            pass
        trk.finish()
    assert [e.get("name") for e in load_events(p)][3:] == ["done"]


def test_span_ids_parents_and_roots():
    """Ids in the order spans open; each child names its parent's id, and
    every span of a tree its depth-0 span's id."""
    trk = InMemoryTracker()
    for _ in range(2):
        with trk.span("call"):
            with trk.span("step"):
                with trk.span("phase"):
                    pass
            with trk.span("step"):
                pass
    by_id = {e["id"]: e for e in trk.span_events}
    assert sorted(by_id) == list(range(1, 9))
    calls = [e for e in trk.span_events if e["name"] == "call"]
    assert [c["id"] for c in calls] == [1, 5]
    for c in calls:
        assert c["parent_id"] is None and c["root"] == c["id"] and "parent" not in c
    for e in trk.span_events:
        if e["depth"]:
            parent = by_id[e["parent_id"]]
            assert parent["name"] == e["parent"] and parent["depth"] == e["depth"] - 1
            assert parent["id"] < e["id"] and e["root"] == parent["root"]
            assert parent["t"] <= e["t"] and e["t"] + e["dur_s"] <= parent["t"] + parent["dur_s"]
    assert [len([e for e in trk.span_events if e["root"] == r]) for r in (1, 5)] == [4, 4]


def _timeline(tmp_path, fn):
    """``fn()`` under a CPU profiler; the exported chrome trace's complete
    events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def test_span_holds_its_operators_on_a_profiler_timeline(tmp_path):
    """A real tracker's span is a range of the same name on the profiler's
    timeline, with the operators it ran inside its interval; a no-op span
    leaves nothing there."""
    x = torch.arange(64.0)
    trk = InMemoryTracker()

    def traced():
        with trk.span("outer/call"):
            with trk.span("inner/op"):
                (x * 2).sum()

    events = _timeline(tmp_path, traced)
    ranges = {e["name"]: e for e in events if e["name"] in ("outer/call", "inner/op")}
    assert set(ranges) == {"outer/call", "inner/op"}
    outer, inner = ranges["outer/call"], ranges["inner/op"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    ops = [e for e in events if e["name"] in ("aten::mul", "aten::sum")]
    assert {e["name"] for e in ops} == {"aten::mul", "aten::sum"}
    for e in ops:
        assert inner["ts"] <= e["ts"] and e["ts"] + e["dur"] <= inner["ts"] + inner["dur"]

    def untraced():
        with NOOP.span("noop/call"):
            (x * 2).sum()

    assert not [e for e in _timeline(tmp_path, untraced) if e["name"] == "noop/call"]


def test_search_and_tile_spans_never_wait(no_sync):
    """An index search and an exact search with a tracker attached: every
    span of both, and none of them synchronizes."""
    idx = OnlineIndex.build(_items(), construct.BuildConfig(k=6, wave=64),
                            generator=torch.Generator().manual_seed(1), device="cpu")
    q = _items(12, seed=5)
    want = idx.search(q, 5)
    trk = InMemoryTracker()
    idx.tracker = trk
    got = idx.search(q, 5)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.n_comps, want.n_comps)
    ids, dists = brute.brute_force_knn(idx.items, q, 5, tile=64, device="cpu", tracker=trk)
    names = {e["name"] for e in trk.span_events}
    assert names == {"index/search", "search/init", "search/done_read", "search/step",
                     "search/select", "search/expand", "search/update", "brute/tile",
                     "brute/pairwise", "brute/topk"}
    assert not any(e["synced"] for e in trk.span_events)
    root = trk.spans("index/search")[0]
    assert all(e["root"] == root["id"] for e in trk.span_events if e["name"].startswith("search/"))


class _Res:
    def __init__(self, comps, full, iters, conv, as_tensor):
        make = torch.tensor if as_tensor else np.asarray
        self.n_comps = make(np.asarray(comps, np.int32))
        self.hash_full = make(np.asarray(full, bool))
        self.n_iters = make(np.asarray(iters, np.int32))
        self.converged = make(np.asarray(conv, bool))


@pytest.mark.parametrize(
    "batches",
    [[([4, 9, 16, 0], [True, False, False, False], [2, 3, 4, 1], [True, True, False, True], 100)],
     [([10], [False], [1], [True], 100), ([10], [False], [1], [True], 300)],
     [([3] * 50 + [40] * 50, [False] * 100, [1] * 100, [True] * 100, None)]],
    ids=["totals", "churn-weighted", "percentiles"],
)
def test_search_stats_equal_the_reference(batches):
    """Every accumulator and derived view equals ``repro.obs.SearchStats``
    fed the same batches (the port's as tensors, the reference's as numpy);
    merge and reset too."""
    got, want = SearchStats(n_items=50), JSearchStats(n_items=50)
    for comps, full, iters, conv, n in batches:
        got.update(_Res(comps, full, iters, conv, True), n_items=n)
        want.update(_Res(comps, full, iters, conv, False), n_items=n)
    _assert_stats_equal(got, want)
    got.merge(got), want.merge(want)
    _assert_stats_equal(got, want)
    got.reset()
    assert got.n_queries == 0 and got.default_n_items == 50 and got.max_comps == 0


def _assert_stats_equal(got, want):
    for name in ("n_queries", "total_comps", "total_iters", "hash_full_queries",
                 "capped_queries", "max_comps", "_n_items_weighted", "comps_per_query",
                 "scanning_rate", "hash_saturation_ratio", "capped_ratio"):
        assert getattr(got, name) == getattr(want, name), name


def _items(n=192, d=8, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).rand(n, d).astype(np.float32))


def test_build_bitwise_identical_with_tracker():
    """And the stride callback fires at the tracker's stride boundaries."""
    x = _items()
    cfg = construct.BuildConfig(k=6, wave=64, n_seed_init=64)
    runs, called = [], []
    for trk in (None, InMemoryTracker()):
        g, st = construct.build(x, cfg, generator=torch.Generator().manual_seed(3),
                                tracker=trk, callback_stride=2, device="cpu",
                                wave_callback=lambda w, g: called.append((w, g.n_valid)))
        runs.append((g, st, trk))
    assert called == [(2, 192), (2, 192)]  # every 2 waves: once per build
    (g0, s0, _), (g1, s1, trk) = runs
    for name in ("nbr_ids", "nbr_dist", "nbr_lam", "rev_ids", "rev_lam"):
        assert torch.equal(getattr(g0, name), getattr(g1, name)), name
    assert int(s0.n_comps) == int(s1.n_comps)
    assert len(trk.spans("build/stride")) == 1  # two waves, stride 2
    assert all(s["synced"] for s in trk.spans("build/stride"))
    assert any("build/n_comps" in e["metrics"] for e in trk.metrics_events)
    with pytest.raises(ValueError, match="callback_stride"):
        construct.build(x, cfg, callback_stride=0, device="cpu")


def test_serving_loop_bitwise_identical_with_tracker():
    """Churn flushes, waves and padding: the same ids with telemetry on and
    off, from the same seeds."""
    x = _items()
    rng = np.random.RandomState(7)
    bursts = [rng.rand(m, 8).astype(np.float32) for m in (5, 3, 8, 1)]
    adds = rng.rand(4, 8).astype(np.float32)

    def run(tracker):
        idx = OnlineIndex.build(x, construct.BuildConfig(k=6, wave=64),
                                generator=torch.Generator().manual_seed(1), device="cpu")
        loop = ServingLoop(idx, ServeLoopConfig(top_k=5, max_batch=8, recall_sample_every=3,
                                                recall_reservoir=4),
                           tracker=tracker, seed=11)
        buckets = []
        loop.submit(bursts[0])
        loop.step()
        loop.add(adds)
        loop.remove(torch.tensor([0, 17]))
        for b in bursts[1:]:
            loop.submit(b)
        while loop.queue_depth:
            buckets.append(loop.step()["bucket"])
        return loop, buckets

    loop0, buckets0 = run(None)
    trk = InMemoryTracker()
    loop1, buckets1 = run(trk)
    assert buckets0 == buckets1
    assert loop0.served == loop1.served == sum(b.shape[0] for b in bursts)
    for a, b in zip(loop0._res_ids + loop0._res_q, loop1._res_ids + loop1._res_q):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(loop0.index.graph.nbr_ids, loop1.index.graph.nbr_ids)
    assert torch.equal(loop0.index.graph.alive, loop1.index.graph.alive)
    assert len(trk.spans("serve/step")) == len(trk.spans("serve/search")) == len(buckets1) + 1
    assert trk.spans("serve/remove")[0]["synced"] is True
    assert trk.spans("index/flush") and trk.spans("index/remove")
