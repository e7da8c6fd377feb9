"""``cardbench/spans.py``: device events attributed to the innermost program
range through ``correlation`` on a hand-written timeline, and the span
pass of a tiny CPU run of each kind of cell."""

import json

import pytest

from conftest import shrink


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _timeline():
    """One call: an index search holding a step (select, update) and a done
    read; kernels run on the device after their launches; a range on
    another thread overlaps the call."""
    return [
        _x("cardbench/index.search", "user_annotation", 0, 1000),
        _x("index/search", "cpu_op", 10, 900),
        _x("search/step", "cpu_op", 20, 500),
        _x("search/select", "cpu_op", 20, 100),
        _x("aten::argmin", "cpu_op", 30, 50),
        _x("cudaLaunchKernel", "cuda_runtime", 40, 5, corr=1),
        _x("search/update", "cpu_op", 300, 200),
        _x("cudaLaunchKernel", "cuda_runtime", 310, 5, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 499, 1, corr=3),
        _x("search/done_read", "cpu_op", 600, 250),
        _x("cudaStreamSynchronize", "cuda_runtime", 610, 230),
        _x("cudaLaunchKernel", "cuda_runtime", 950, 5, corr=4),  # outside index/search
        _x("brute/tile", "cpu_op", 0, 2000, tid=2),  # another thread
        _x("argmin_kernel", "kernel", 100, 7, tid=9, corr=1),
        _x("reduce_kernel", "kernel", 400, 11, tid=9, corr=2),
        _x("compare_kernel", "kernel", 520, 13, tid=9, corr=3),
        _x("tail_kernel", "kernel", 960, 17, tid=9, corr=4),
        _x("Memcpy DtoH", "gpu_memcpy", 620, 3, tid=9),  # no correlation
    ]


def test_device_time_goes_to_the_innermost_range_of_the_launch():
    from cardbench import spans

    got = spans.device_by_span(_timeline())
    # the last launch falls after index/search; the copy has no launch
    assert dict(got["device_s"]) == pytest.approx({"search/select": 7e-6, "search/update": 24e-6,
                                                   None: 20e-6})
    assert got["total_s"] == pytest.approx(51e-6)
    assert got["ranges"] == {"index/search": 1, "search/step": 1, "search/select": 1,
                             "search/update": 1, "search/done_read": 1, "brute/tile": 1}
    assert got["waits"] == {"search/done_read > cudaStreamSynchronize": 1}


def test_summary_per_iteration_and_per_tile():
    from cardbench import spans

    host = [{"event": "span", "name": n, "dur_s": d} for n, d in (
        ("search/step", 2e-3), ("search/step", 4e-3), ("search/done_read", 1e-3),
        ("index/search", 8e-3))]
    s = spans.summary(host, _timeline(), calls=1, profiled_calls=1)
    assert s["search_issue_ms_per_iter"] == pytest.approx(3.0)
    assert s["host"]["search/done_read"]["mean_ms"] == pytest.approx(1.0)
    assert s["step_and_done_share_of_index_search"] == pytest.approx(7 / 8)
    assert s["search_update_device_ms_per_iter"] == pytest.approx(24e-3)
    assert s["search_update_device_share"] == pytest.approx(24 / 51)
    assert "brute_topk_device_ms_per_tile" not in s
    # without device events no device number is read
    cpu = spans.summary(host, [e for e in _timeline() if e["cat"] != "kernel"
                               and e["cat"] != "gpu_memcpy"], calls=1, profiled_calls=1)
    assert cpu["search_update_device_ms_per_iter"] is None
    assert cpu["device_ms_per_call"] is None and cpu["search_update_device_share"] is None


@pytest.mark.parametrize("cell", ["sift1m.batch10k", "sift1m.exact10k"])
def test_tiny_span_pass(bench_root, tmp_path, cell):
    from cardbench import spans

    res = spans.run(cell, 2**33 + 5, root=bench_root, calls=2, out_dir=tmp_path, device="cpu",
                    shrink=shrink)
    assert res["device"] == "cpu" and res["device_total_ms_per_call"] is None
    assert len(res["plain_call_ms"]) == len(res["traced_call_ms"]) == 2
    lines = (tmp_path / f"{cell}.spans.jsonl").read_text().splitlines()
    events = [json.loads(line) for line in lines]
    assert events and all({"id", "parent_id", "root"} <= set(e) for e in events)
    timeline = json.loads((tmp_path / f"{cell}.spans.json").read_text())["traceEvents"]
    names = {e.get("name") for e in timeline}
    if "batch" in cell:
        assert res["search_issue_ms_per_iter"] > 0 and res["host"]["search/done_read"]["mean_ms"] > 0
        assert res["search_update_device_ms_per_iter"] is None
        assert 0 < res["step_and_done_share_of_index_search"] <= 1
        assert {"index/search", "search/step", "search/update"} <= names
        roots = {e["id"] for e in events if e["name"] == "index/search"}
        assert len(roots) == 2 and all(e["root"] in roots for e in events)
    else:
        assert res["host"]["brute/tile"]["per_call"] == 1  # 2,000 rows: one tile
        assert res["host"]["brute/topk"]["mean_ms"] > 0
        assert res["brute_topk_device_ms_per_tile"] is None
        assert {"brute/tile", "brute/pairwise", "brute/topk"} <= names
