"""The static-shape segment primitives (``repro_torch.core.segments``)
against the data-dependent forms they replace.

``grouped_top_r`` and ``segment_counts`` now scatter into a buffer with one
dump row (or slot) and slice it off, with no boolean indexing, no
``nonzero`` and no host read.  They copy values and count integers, so on
random sorted keys, keys at and past ``num_segments`` and segments longer
than ``r`` included, they equal the old forms (kept here as the oracle)
bit for bit, and both run under ``FakeTensorMode``, where the old forms
cannot size their outputs.  The visited-hash ``record`` and the reverse-list
``append_reverse``, which scatter the same way now, run under it too.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_parity as tp
from repro_torch.core import merge, segments
from repro_torch.kernels import expand

torch.set_num_threads(2)


def old_segment_counts(sorted_keys, num_segments):
    valid = sorted_keys < num_segments
    counts = torch.bincount(sorted_keys[valid].long(), minlength=num_segments)
    return counts[:num_segments].to(torch.int32)


def old_grouped_top_r(sorted_keys, payloads, fills, num_segments, r):
    rank = segments.segment_rank(sorted_keys)
    ok = (sorted_keys < num_segments) & (rank < r)
    row, col = sorted_keys[ok].long(), rank[ok].long()
    buffers = []
    for payload, fill in zip(payloads, fills):
        buf = torch.full((num_segments, r), fill, dtype=payload.dtype)
        buf[row, col] = payload[ok]
        buffers.append(buf)
    return buffers, old_segment_counts(sorted_keys, num_segments)


def _keys(seed, T, S):
    """Sorted keys over [0, S + 3): runs longer than r, keys past S."""
    rs = np.random.RandomState(seed)
    return torch.from_numpy(np.sort(rs.randint(0, S + 3, T))).int()


@pytest.mark.parametrize("seed,T,S,r", [(0, 200, 12, 3), (1, 64, 40, 5), (2, 500, 5, 8),
                                        (3, 1, 4, 2), (4, 0, 4, 2)])
def test_static_forms_equal_the_old_forms(seed, T, S, r):
    keys = _keys(seed, T, S)
    rs = np.random.RandomState(seed + 10)
    ids = torch.from_numpy(rs.randint(-1, 1000, T)).int()
    dist = torch.from_numpy(tp.gauss_data(max(T, 1), 1, seed)[:T, 0])
    flag = torch.from_numpy(rs.rand(T) < 0.5)
    payloads, fills = [ids, dist, flag], [-1, float("inf"), False]
    (g_ids, g_d, g_f), g_c = segments.grouped_top_r(keys, payloads, fills, S, r)
    (w_ids, w_d, w_f), w_c = old_grouped_top_r(keys, payloads, fills, S, r)
    for got, want in ((g_ids, w_ids), (g_d, w_d), (g_f, w_f), (g_c, w_c)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(segments.segment_counts(keys, S), old_segment_counts(keys, S))


def test_static_forms_trace_on_fakes():
    with FakeTensorMode():
        keys = torch.empty(300, dtype=torch.int32)
        pay = torch.empty(300, dtype=torch.float32)
        (buf,), counts = segments.grouped_top_r(keys, [pay], [0.0], 16, 4)
        assert tuple(buf.shape) == (16, 4) and tuple(counts.shape) == (16,)
        with pytest.raises(Exception):  # the old form's boolean index cannot be sized
            old_grouped_top_r(keys, [pay], [0.0], 16, 4)
        vis_ids = torch.empty(8, 64, dtype=torch.int32)
        vis_dist = torch.empty(8, 64)
        ids = torch.empty(8, 5, dtype=torch.int32)
        expand.record(vis_ids, vis_dist, ids, torch.empty(8, 5), torch.empty(8, 5, dtype=torch.bool),
                      torch.empty(8, 5, dtype=torch.int64))
        rev = merge.append_reverse(torch.empty(50, 6, dtype=torch.int32),
                                   torch.empty(50, 6, dtype=torch.int32),
                                   torch.empty(50, dtype=torch.int32),
                                   torch.empty(40, dtype=torch.int32),
                                   torch.empty(40, dtype=torch.int32))
        assert [tuple(t.shape) for t in rev] == [(50, 6), (50, 6), (50,)]
