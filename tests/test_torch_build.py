"""Port build: the slice gate against the JAX reference.

* Integer-valued data and the reference's replayed entry points: the port's
  graph arrays and counters equal ``repro.core.construct.build(...,
  dispatch="reference")`` bit for bit at W=1 (the paper's sequential
  algorithm) and W=64.
* N(0,1) data, n=2000, d=20: recall@10 >= 0.95 and within 0.01 of the
  reference, scanning rate within 5%, every graph invariant true.

``test_torch_wide_wave.py`` holds the same comparisons where a wave is
wider than the graph it searches, as on the knn-lgd main path; it is a file
of its own so that each file runs within 60 s on one worker.
"""

import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro_torch.core import construct as tconstruct
from repro_torch.core import graph as tgraph
from repro_torch.launch import build_graph as tlaunch

torch.set_num_threads(2)


# The knn-lgd search shape at the gate's size.  The W=64 bit-exact case and
# the Gaussian case share it, and with it one compile of the reference.
GATE_N, GATE_D = 2000, 20
GATE = dict(k=24, wave=64, beam=48, n_seeds=8, lgd=True)


@pytest.mark.parametrize(
    "n,d,kw",
    [(70, 8, dict(wave=1, k=6, beam=12, n_seeds=3, n_seed_init=16, hash_slots=128,
                   max_iters=16, lgd=True)),
     (GATE_N, GATE_D, GATE)],
    ids=["W=1", "W=64"],
)
def test_build_bit_identical_on_integer_data(n, d, kw):
    x = tp.int_data(n, d, seed=1)
    (g_j, st_j), (g_t, st_t) = tp.build_both(x, 3, **kw)
    tp.assert_graphs_equal(g_t, g_j, kw["wave"])
    assert int(st_t.n_comps) == int(st_j.n_comps)
    assert int(st_t.n_inserted_edges) == int(st_j.n_inserted_edges)
    assert st_t.n_waves == int(st_j.n_waves)


def test_build_gaussian_recall_and_scanning_rate():
    n = GATE_N
    x = tp.gauss_data(n, GATE_D, seed=0)
    (g_j, st_j), (g_t, st_t) = tp.build_both(x, 0, **GATE)
    r_t, r_j = tp.graph_recalls(x, g_t, g_j)
    assert r_t >= 0.95 and abs(r_t - r_j) <= 0.01, (r_t, r_j)
    c_t, c_j = tconstruct.scanning_rate(st_t, n), jconstruct.scanning_rate(st_j, n)
    assert abs(c_t - c_j) <= 0.05 * c_j, (c_t, c_j)
    assert all(bool(v.all()) for v in tgraph.graph_invariants_ok(g_t).values())


def test_launcher_runs_on_cpu(capsys):
    tlaunch.main(["--n", "700", "--d", "8", "--k", "8", "--wave", "128",
                  "--eval-sample", "100", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "built LGD graph on cpu" in out and "graph recall@8" in out
