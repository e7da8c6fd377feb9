"""Port graph data (``repro_torch.data.graphs``) and the atom-graph build
against the JAX package on the same numpy inputs.

* ``csr_from_edges`` and ``knn_edges_from_positions``: ids bit for bit on
  integer positions full of ties (ties go to the lower index, as
  ``lax.top_k``'s).
* ``random_graph``, ``sample_neighbors`` and ``khop_sample`` on the
  reference's draws, replayed: every array bit for bit.
* The atom graph: a d=3 LGD build (k=8, W=256, the example's) on integer
  positions, the reference's entry points replayed: every graph array and
  counter bit for bit.
* ``examples/molecule_graphs_torch.py`` on the CPU.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.data import graphs as jgraphs
from repro_torch.data import graphs as tgraphs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def test_csr_from_edges_equals_the_reference():
    rs = np.random.RandomState(0)
    n, e = 50, 400
    snd = rs.randint(0, n, e).astype(np.int32)
    rcv = rs.randint(0, n // 3, e).astype(np.int32)  # many edges per receiver, some nodes none
    want = jgraphs.csr_from_edges(jnp.asarray(snd), jnp.asarray(rcv), n)
    got = tgraphs.csr_from_edges(torch.from_numpy(snd), torch.from_numpy(rcv), n)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n,k,high", [(30, 2, 4), (30, 8, 3), (64, 5, 16)])
def test_knn_edges_equal_the_reference_with_ties(n, k, high):
    pos = np.random.RandomState(n + k).randint(0, high, (n, 3)).astype(np.float32)
    want = jax.jit(jgraphs.knn_edges_from_positions, static_argnums=1)(jnp.asarray(pos), k)
    got = tgraphs.knn_edges_from_positions(torch.from_numpy(pos), k)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_random_graph_equals_the_reference_on_its_draws():
    key = jax.random.PRNGKey(4)
    n, e, d, c = 300, 2000, 6, 7
    want = jgraphs.random_graph(key, n, e, d, n_classes=c)
    ks, kr, kf, kl = jax.random.split(key, 4)
    draws = (jax.random.uniform(kr, (e,)), jax.random.randint(ks, (e,), 0, n, dtype=jnp.int32),
             jax.random.normal(kf, (n, d), jnp.float32),
             jax.random.randint(kl, (n,), 0, c, dtype=jnp.int32))
    got = tgraphs.random_graph_from_draws(*(torch.from_numpy(np.array(a)) for a in draws), n)
    for name in tgraphs.Graph._fields:
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name


def test_random_graph_draws_on_its_generator():
    g = tgraphs.random_graph(torch.Generator().manual_seed(1), 256, 2048, 5, n_classes=3)
    assert g.senders.shape == g.receivers.shape == g.indices.shape == (2048,)
    assert g.indptr.shape == (257,) and int(g.indptr[-1]) == 2048
    assert g.features.shape == (256, 5) and int(g.labels.max()) < 3
    deg = torch.bincount(g.receivers.long(), minlength=256)
    assert int(deg[:26].sum()) > int(deg[-26:].sum()) * 5  # hubs at low ranks
    again = tgraphs.random_graph(torch.Generator().manual_seed(1), 256, 2048, 5, n_classes=3)
    assert all(torch.equal(a, b) for a, b in zip(g, again))


@pytest.fixture(scope="module")
def csr():
    g = jgraphs.random_graph(jax.random.PRNGKey(5), 200, 900, 2)
    isolated = np.asarray(g.indptr)[1:] == np.asarray(g.indptr)[:-1]
    assert isolated.any()  # the self-loop branch runs
    return g, isolated


def test_sample_neighbors_equals_the_reference_on_its_uniforms(csr):
    g, isolated = csr
    seeds = np.concatenate([np.flatnonzero(isolated)[:5], np.arange(0, 200, 7)]).astype(np.int32)
    key = jax.random.PRNGKey(6)
    want = jgraphs.sample_neighbors(key, g.indptr, g.indices, jnp.asarray(seeds), 15)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (seeds.size, 15))))
    got = tgraphs.sample_neighbors(torch.from_numpy(np.array(g.indptr)),
                                   torch.from_numpy(np.array(g.indices)),
                                   torch.from_numpy(seeds), 15, u=u)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_khop_sample_equals_the_reference_on_its_uniforms(csr):
    g, _ = csr
    seeds = np.arange(0, 200, 13).astype(np.int32)
    key, fanouts = jax.random.PRNGKey(8), (5, 3)
    want = jgraphs.khop_sample(key, g.indptr, g.indices, jnp.asarray(seeds), fanouts)
    uniforms, size = [], seeds.size
    for li, f in enumerate(fanouts):
        uniforms.append(torch.from_numpy(np.array(
            jax.random.uniform(jax.random.fold_in(key, li), (size, f)))))
        size *= f
    got = tgraphs.khop_sample(torch.from_numpy(np.array(g.indptr)),
                              torch.from_numpy(np.array(g.indices)), torch.from_numpy(seeds),
                              fanouts, uniforms=uniforms)
    assert [tuple(a.shape) for a in got] == [(16,), (16, 5), (16, 5, 3)]
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    drawn = tgraphs.khop_sample(torch.from_numpy(np.array(g.indptr)),
                                torch.from_numpy(np.array(g.indices)), torch.from_numpy(seeds),
                                fanouts, generator=torch.Generator().manual_seed(0))
    assert [tuple(a.shape) for a in drawn] == [(16,), (16, 5), (16, 5, 3)]


def test_molecules_shapes_and_ranges():
    pos, spec = tgraphs.molecules(torch.Generator().manual_seed(0), 4, 30, n_species=8, box=6.0)
    assert pos.shape == (4, 30, 3) and spec.shape == (4, 30) and spec.dtype == torch.int32
    assert 0.0 <= float(pos.min()) and float(pos.max()) < 6.0
    assert 0 <= int(spec.min()) and int(spec.max()) < 8


def test_atom_build_bit_identical_to_the_reference():
    """d=3 on integer positions (16³ cells for 1,200 atoms, so equal
    distances abound): the example's build (k=8, l2, LGD, W=256)."""
    x = tp.int_data(1200, 3, seed=2)
    (g_j, st_j), (g_t, st_t) = tp.build_both(x, 5, k=8, wave=256, lgd=True, n_seeds=8)
    tp.assert_graphs_equal(g_t, g_j, "d=3")
    assert int(st_t.n_comps) == int(st_j.n_comps)
    assert int(st_t.n_inserted_edges) == int(st_j.n_inserted_edges)


def test_molecule_example_runs_on_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "molecule_graphs_torch", ROOT / "examples" / "molecule_graphs_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    rec = example.main(["--device", "cpu", "--n-atoms", "1500"])
    out = capsys.readouterr().out
    assert "LGD neighbour graph over 1500 atoms on cpu" in out and "MACE energy" in out
    assert rec["recall"] >= 0.95 and 0 < rec["scanning_rate"] < 0.3
    assert rec["n_edges"] == 1500 * 8 and np.isfinite(rec["energy"])
    assert rec["forces"].shape == (1500, 3) and bool(torch.isfinite(rec["forces"]).all())
