"""Port build against the JAX reference where a wave is wider than the graph
it searches.

The knn-lgd main path inserts waves of W=4096 rows into a graph that starts
from a 256-row exact seed graph: its first wave is 16 times wider than the
graph, and every wave's rows see one another only through the intra-wave
tile.  These cases put the port in that regime at a size the CPU can run,
with the knn-lgd search shape (k=20, beam 40, 8 seeds, 60 iterations,
auto-sized hash):

* integer-valued data, n=600, W=512 over a 64-row seed graph: graph arrays
  and counters bit for bit;
* N(0,1) data, n=2000, W=512 over a 32-row seed graph: recall@10 within
  0.01 of the reference, scanning rate within 5%, every graph invariant
  true.
"""

import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro_torch.core import construct as tconstruct
from repro_torch.core import graph as tgraph

torch.set_num_threads(2)

KNN_LGD = dict(k=20, beam=40, n_seeds=8, lgd=True)


def test_wide_wave_bit_identical_on_integer_data():
    x = tp.int_data(600, 16, seed=5)
    kw = dict(KNN_LGD, wave=512, n_seed_init=64)
    (g_j, st_j), (g_t, st_t) = tp.build_both(x, 6, **kw)
    tp.assert_graphs_equal(g_t, g_j, "W=512 n_seed_init=64")
    assert int(st_t.n_comps) == int(st_j.n_comps)
    assert int(st_t.n_inserted_edges) == int(st_j.n_inserted_edges)
    assert st_t.n_waves == int(st_j.n_waves) == 2


def test_wide_wave_gaussian_recall_and_scanning_rate():
    n = 2000
    x = tp.gauss_data(n, 20, seed=7)
    (g_j, st_j), (g_t, st_t) = tp.build_both(x, 8, **KNN_LGD, wave=512, n_seed_init=32)
    r_t, r_j = tp.graph_recalls(x, g_t, g_j)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    c_t, c_j = tconstruct.scanning_rate(st_t, n), jconstruct.scanning_rate(st_j, n)
    assert abs(c_t - c_j) <= 0.05 * c_j, (c_t, c_j)
    assert all(bool(v.all()) for v in tgraph.graph_invariants_ok(g_t).values())
