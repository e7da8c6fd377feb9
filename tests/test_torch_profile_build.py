"""The expansion count of ``repro_torch.launch.profile_build`` on the CPU.

``count_expansions`` reads fresh and recorded candidates from the search
state around each step, and valid ones from the expansion's inputs; here
each is held against a direct count of the same launches (the plain
expansion's comps, its hash before and after, its candidates).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import construct
from repro_torch.kernels import ops
from repro_torch.launch import profile_build

torch.set_num_threads(2)


@pytest.mark.parametrize("precision,row_bytes", [("fp32", 20), ("bf16", 10), ("int8", 9)])
def test_expand_bytes_counts_each_operand(precision, row_bytes):
    B, C, e, d, P = 2, 3, 4, 5, 6
    fresh, valid, inserted = 2, 3, 1
    want = (4 * (B * d + B * C + fresh) + fresh * row_bytes + 4 * valid * P + 8 * inserted
            + 2 * B * e * 9 + 4 * B)
    got = profile_build.expand_bytes(B, C, e, d, P, precision, fresh, valid, inserted)
    assert got == want


def test_bound_names_the_larger_time():
    t, how = profile_build.bound_ms(3.35e9, 1.0)
    assert how == "bytes" and t == pytest.approx(1.0)
    t, how = profile_build.bound_ms(1.0, 67e9)
    assert how == "operations" and t == pytest.approx(1.0)


def test_bound_takes_the_rate_of_the_operand_type():
    # bf16 x bf16 products run on the tensor cores: 989 TFLOP/s dense
    t, how = profile_build.bound_ms(1.0, 989e9, "bf16")
    assert how == "operations" and t == pytest.approx(1.0)
    # the 4096^2 x 128 bf16-operand tile is bound by its bytes there
    nbytes = 2 * (2 * 4096 * 128) + 4 * (4096 + 4096 * 4096)
    t, how = profile_build.bound_ms(nbytes, 2 * 4096 * 4096 * 128, "bf16")
    assert how == "bytes" and t == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_count_expansions_matches_a_direct_count(monkeypatch):
    x = torch.from_numpy(np.random.RandomState(3).randint(0, 16, (700, 8)).astype(np.float32))
    cfg = construct.BuildConfig(k=5, wave=64, beam=12, n_seeds=3, max_iters=10)
    direct = {"launches": 0, "fresh": 0, "valid": 0, "inserted": 0}
    plain = ops.expand_step

    def expand_step(q, x_, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, **kw):
        before = int((vis_ids >= 0).sum())
        out = plain(q, x_, cands, beam_ids, beam_dist, beam_exp, vis_ids, vis_dist, **kw)
        direct["launches"] += 1
        direct["fresh"] += int(out[5].sum())
        direct["valid"] += int((cands >= 0).sum())
        direct["inserted"] += int((out[3] >= 0).sum()) - before
        return out

    monkeypatch.setattr(ops, "expand_step", expand_step)
    c = profile_build.count_expansions(x, cfg)
    n = direct["launches"]
    assert c["launches"] == n > 0
    for name in ("fresh", "valid", "inserted"):
        assert c[name] == pytest.approx(direct[name] / n), name
    assert 0 < c["inserted"] <= c["fresh"] <= c["valid"]
    assert c["bound_ms"] > 0 and c["bound_by"] == "bytes"
