"""Port build at compressed precisions against the JAX reference.

* Integer-valued data and the reference's replayed entry points: the W=64
  builds at int8, bf16 and pq give graph arrays and counters equal to
  ``repro.core.construct.build(..., dispatch="reference", precision=...)``
  bit for bit.  The searches run on the compressed table; the commit's
  intra-wave tile stays fp32, as in the reference.
* N(0,1) data, n=2000, d=20, int8: recall@10 within 0.01 of the
  reference's and scanning rate within 5%, every graph invariant true.
"""

import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro_torch.core import construct as tconstruct
from repro_torch.core import graph as tgraph

torch.set_num_threads(2)

# the knn-lgd search shape at a test's size
SMALL = dict(k=10, wave=64, beam=20, n_seeds=4, lgd=True, max_iters=30)


@pytest.mark.parametrize("precision", ["int8", "bf16", "pq"])
def test_build_bit_identical_on_integer_data(precision):
    x = tp.int_data(500, 16, seed=2)
    kw = dict(SMALL, precision=precision)
    if precision == "pq":
        kw["rerank_factor"] = 1  # keep 10 of up to 30 candidates
    (g_j, st_j), (g_t, st_t) = tp.build_both(x, 5, **kw)
    tp.assert_graphs_equal(g_t, g_j, precision)
    assert int(st_t.n_comps) == int(st_j.n_comps)
    assert int(st_t.n_inserted_edges) == int(st_j.n_inserted_edges)
    assert st_t.n_waves == int(st_j.n_waves)


def test_int8_build_gaussian_recall_and_scanning_rate():
    n = 2000
    x = tp.gauss_data(n, 20, seed=0)
    kw = dict(k=24, wave=64, beam=48, n_seeds=8, lgd=True, precision="int8")
    (g_j, st_j), (g_t, st_t) = tp.build_both(x, 0, **kw)
    r_t, r_j = tp.graph_recalls(x, g_t, g_j)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    c_t, c_j = tconstruct.scanning_rate(st_t, n), jconstruct.scanning_rate(st_j, n)
    assert abs(c_t - c_j) <= 0.05 * c_j, (c_t, c_j)
    assert all(bool(v.all()) for v in tgraph.graph_invariants_ok(g_t).values())


def test_build_config_carries_precision():
    cfg = tconstruct.BuildConfig(k=8, precision="pq", rerank_factor=7)
    scfg = cfg.search_config()
    assert (scfg.precision, scfg.rerank_factor) == ("pq", 7)
    with pytest.raises(ValueError):
        tconstruct.BuildConfig(precision="fp8")
