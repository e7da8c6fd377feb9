"""The byte count and the inputs of ``repro_torch.launch.bench_gather`` on
the CPU (its timings need a card)."""

import pytest
import torch

from repro_torch.launch import bench_gather, profile_build

torch.set_num_threads(2)


@pytest.mark.parametrize("precision,row_bytes", [("fp32", 20), ("bf16", 10), ("int8", 9)])
def test_gather_bytes_counts_each_operand(precision, row_bytes):
    B, C, d, rows = 2, 3, 5, 4
    want = 4 * B * d + 4 * B * C + 4 * rows + rows * row_bytes + 4 * B * C
    assert bench_gather.gather_bytes(B, C, d, rows, precision) == want


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_gather_bound_reads_each_distinct_row_once(precision):
    """A row named twice is moved once; every valid id is a distance."""
    idx = torch.tensor([[0, 0, 1], [-1, 1, 2]], dtype=torch.int32)
    d = 5
    t, how = bench_gather.gather_bound(idx, d, precision)
    assert (t, how) == profile_build.bound_ms(bench_gather.gather_bytes(2, 3, d, 3, precision),
                                              2 * d * 5)


def test_main_inputs_draw_queries_and_ids_from_the_rows():
    x = torch.randn(50, 6)
    q, idx = bench_gather.main_inputs(x)
    B, C, _ = bench_gather.SHAPES["main"]
    assert q.shape == (B, 6) and idx.shape == (B, C) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 50
    # every query is one of the rows
    assert bool((q[:, None, :] == x[None]).all(-1).any(1).all())
    q2, idx2 = bench_gather.main_inputs(x)
    assert torch.equal(q, q2) and torch.equal(idx, idx2)
    q3, idx3 = bench_gather.main_inputs(x, 1)
    assert not torch.equal(idx, idx3)


def test_timing_sets_draw_each_set_anew(monkeypatch):
    """Two warm-up sets and COLD_SETS timed ones, no two alike, set 0 the
    shape's own inputs."""
    monkeypatch.setattr(bench_gather, "COLD_SETS", 3)
    x = torch.randn(300, bench_gather.SHAPES["large_c"][2])
    sets = bench_gather.timing_sets("large_c", x)
    assert len(sets) == 5
    q0, idx0 = bench_gather.large_c_queries(x)
    assert torch.equal(sets[0][0], q0) and torch.equal(sets[0][1], idx0)
    for i in range(5):
        for j in range(i):
            assert not torch.equal(sets[i][1], sets[j][1])
    main = bench_gather.timing_sets("main", x[:, :8])
    assert torch.equal(main[1][1], bench_gather.main_inputs(x[:, :8], 1)[1])


@pytest.mark.parametrize("integer", [False, True])
def test_large_c_inputs(integer):
    x, q, idx = bench_gather.large_c_inputs(torch.device("cpu"), n=300, integer=integer)
    B, C, d = bench_gather.SHAPES["large_c"]
    assert x.shape == (300, d) and q.shape == (B, d) and idx.shape == (B, C)
    assert x.dtype == q.dtype == torch.float32 and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 300
    if integer:
        assert bool((x == x.round()).all()) and 0 <= float(x.min()) and float(x.max()) < 16
