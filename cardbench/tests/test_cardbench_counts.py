"""The frozen counts of work equal PERF.md §6's bounds at its shapes, and
the copies equal the program's arithmetic they were taken from."""

import pytest

from cardbench import peaks


@pytest.mark.parametrize("m, n, d, elem, cached, want, by", [
    (4096, 4096, 128, 4, True, 0.064104, "operations"),    # the build's intra-wave tile
    (96, 8192, 128, 4, False, 0.003005, "operations"),     # the recall audit's brute tile
    (4096, 4000, 128, 4, False, 0.062602, "operations"),   # nearest_landmark's chunk
    (100000, 8192, 3, 4, False, 0.978537, "bytes"),        # the atom graph's exact tile
    (4096, 4096, 128, 2, True, 0.020663, "bytes"),         # bf16 operands (at the bf16 rate)
])
def test_pairwise_bounds_match_the_kernel_table(m, n, d, elem, cached, want, by):
    flops, nbytes = peaks.pairwise_cost(m, n, d, elem_bytes=elem, cached_norms=cached)
    got, how = peaks.bound_ms(nbytes, flops, "bf16" if elem == 2 else "fp32")
    assert how == by and got == pytest.approx(want, abs=5e-7)


def test_exact_search_bound_of_a_sift1m_call():
    flops, nbytes = peaks.exact_search_cost(10_000, 1_000_000, 128, 10)
    got, how = peaks.bound_ms(nbytes, flops)
    assert how == "operations" and got == pytest.approx(38.2089552, rel=1e-6)


@pytest.mark.parametrize("args", [
    (4096, 60, 40, 128, 8, "fp32", 120_000, 200_000, 110_000),
    (64, 60, 64, 128, 8, "bf16", 1_000, 2_000, 900),
    (16384, 60, 40, 100, 1, "int8", 0, 0, 0),
])
def test_expand_bytes_is_the_programs_count(args):
    from repro_torch.launch import profile_build

    assert peaks.expand_bytes(*args) == profile_build.expand_bytes(*args)


@pytest.mark.parametrize("args", [(4096, 8, 128, 32239, "fp32"), (64, 44, 128, 2800, "int8")])
def test_gather_bytes_is_the_programs_count(args):
    from repro_torch.launch import bench_gather

    assert peaks.gather_bytes(*args) == bench_gather.gather_bytes(*args)


def test_peaks_are_the_programs():
    from repro_torch.launch import profile_build

    assert peaks.HBM_BYTES_PER_S == profile_build.HBM_BYTES_PER_S
    assert peaks.FLOP_PER_S == profile_build.FLOP_PER_S
    assert peaks.bound_ms(1e9, 1e12) == profile_build.bound_ms(1e9, 1e12)
