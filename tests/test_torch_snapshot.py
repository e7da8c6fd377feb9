"""Port snapshots (``index.snapshot``) and the coarse index's lifecycle,
against the JAX reference (``dispatch="reference"``).

Both packages write the same v3 format, so a snapshot written by either
loads in the other and serves the same top-k; a v1 payload re-derives its
caches, one without the reverse side rebuilds it, and a newer
``format_version`` is refused, as ``tests/test_lifecycle.py::TestSnapshot``
holds the reference.  The index carries a coarse level, a churned ledger
and (for the cross-package cases) a PQ codebook.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.index import OnlineIndex as JIndex
from repro.index import snapshot as jsnap
from repro_torch.core import graph as tgraph
from repro_torch.index import OnlineIndex as TIndex
from repro_torch.index import snapshot as tsnap

torch.set_num_threads(2)

N, D, P = 600, 8, 4
COARSE = dict(k=8, metric="l2", wave=64, lgd=True, beam=24, n_seeds=P, hash_slots=512,
              max_iters=32, seed_mode="coarse", coarse_landmarks=48, coarse_members=4)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


@pytest.fixture(scope="module")
def data():
    return tp.int_data(N, D, seed=0)


@pytest.fixture(scope="module")
def churned(data):
    """Both packages' coarse index after an insert (which appends the new
    rows to their cells) and a removal."""
    jidx, tidx = tp.online_index_both(data, COARSE, capacity=N + 64)
    tp.assert_index_equal(tidx, jidx, "coarse build")
    before = int(tidx.coarse.mem_ptr.sum())
    tp.add_both(jidx, tidx, tp.int_data(16, D, seed=9), 2)
    tp.assert_index_equal(tidx, jidx, "coarse insert")
    assert int(tidx.coarse.mem_ptr.sum()) > before
    victims = np.arange(0, 60, 3, dtype=np.int32)
    jidx.remove(jnp.asarray(victims))
    tidx.remove(torch.from_numpy(victims))
    tp.assert_index_equal(tidx, jidx, "churned")
    return jidx, tidx


def test_coarse_lifecycle_matches(churned):
    """Under coarse seeding remove masks a dead landmark's row and compact
    remaps the level, as the reference does (the insert is the fixture's)."""
    jidx, tidx = (i.clone() for i in churned)
    victim = int(tidx.coarse.landmark_rows[1])
    jidx.remove(jnp.asarray([victim], jnp.int32))
    tidx.remove(torch.tensor([victim]))
    tp.assert_index_equal(tidx, jidx, "coarse remove")
    assert int(tidx.coarse.landmark_rows[1]) == -1
    assert victim not in tidx.coarse.members.flatten().tolist()
    q = tp.int_data(4, D, seed=42)
    got, _ = tp.search_both(jidx, tidx, q, 5, seed=4)
    assert bool((got.seed_cell >= 0).all())
    jidx.compact()
    tidx.compact()
    tp.assert_index_equal(tidx, jidx, "coarse compact")
    nv = tidx.graph.n_valid
    for a in (tidx.coarse.landmark_rows, tidx.coarse.members):
        assert bool((a[a >= 0] < nv).all())
    tp.search_both(jidx, tidx, q, 5, seed=4)


def test_port_round_trip_bit_exact(churned, tmp_path):
    """Every array (caches and coarse level included), the ledger and the
    config come back; the same search gives the same bits; an overwrite
    leaves no staging directory behind."""
    _, tidx = churned
    path = str(tmp_path / "snap")
    tidx.save(path)
    tidx.save(path)  # staged and swapped over the first
    assert sorted(os.listdir(tmp_path)) == ["snap"]
    back = TIndex.load(path, device="cpu")
    for name in tp.GRAPH_FIELDS:
        a, b = getattr(back.graph, name), getattr(tidx.graph, name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b), name
    assert torch.equal(back.items, tidx.items)
    assert back.free_ids == tidx.free_ids and back.build_cfg == tidx.build_cfg
    for name in ("landmark_rows", "points", "members", "mem_ptr"):
        assert torch.equal(getattr(back.coarse, name), getattr(tidx.coarse, name)), name
    q = torch.from_numpy(tp.int_data(8, D, seed=42))
    r0, r1 = tidx.search(q, 5), back.search(q, 5)
    assert torch.equal(r0.ids, r1.ids) and torch.equal(r0.dists, r1.dists)


def _as_pq(idx):
    """Switch an index to PQ serving (re-rank width 8k keeps every
    candidate at this shape, so the top-k is exact) and train its codebook."""
    idx.build_cfg = dataclasses.replace(idx.build_cfg, precision="pq", rerank_factor=8)
    idx._enc = None
    idx._ensure_enc()
    assert idx.pq_codebook is not None


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_cross_package_snapshot(churned, tmp_path, writer):
    """A snapshot written by one package loads in the other: the same
    arrays, coarse level, codebook and ledger, and the same top-k."""
    jidx, tidx = churned
    jidx, tidx = jidx.clone(), tidx.clone()
    src = jidx if writer == "repro" else tidx
    _as_pq(src)
    path = src.save(str(tmp_path / writer))
    if writer == "repro":
        jidx, tidx = src, TIndex.load(path, device="cpu")
        np.testing.assert_array_equal(tidx.pq_codebook.numpy(), np.asarray(jidx.pq_codebook))
    else:
        jidx, tidx = JIndex.load(path), src
        np.testing.assert_array_equal(np.asarray(jidx.pq_codebook), tidx.pq_codebook.numpy())
        assert jidx.build_cfg.dispatch == "auto"
        jidx.build_cfg = dataclasses.replace(jidx.build_cfg, dispatch="reference")
    assert tidx.build_cfg.precision == jidx.build_cfg.precision == "pq"
    assert tidx.build_cfg.seed_mode == jidx.build_cfg.seed_mode == "coarse"
    tp.assert_index_equal(tidx, jidx, writer)
    got, _ = tp.search_both(jidx, tidx, tp.int_data(16, D, seed=42), 5, seed=6)
    assert bool((got.ids >= 0).all())


def _rewrite(path, drop=(), **manifest_kw):
    npz = os.path.join(path, tsnap.PAYLOAD_NAME)
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files if k not in drop and not k.startswith(drop)}
    np.savez(npz, **arrays)
    man_path = os.path.join(path, tsnap.MANIFEST_NAME)
    with open(man_path) as f:
        man = json.load(f)
    man.update(manifest_kw)
    with open(man_path, "w") as f:
        json.dump(man, f)


def test_legacy_payloads_load_as_the_reference_loads_them(churned, tmp_path):
    """A v1 payload (no caches, no coarse level) re-derives the caches, a
    payload without the reverse side rebuilds it: the port's restore equals
    the reference's; a coarse index re-derives its level from v1."""
    jidx, tidx = churned
    v1 = tidx.save(str(tmp_path / "v1"))
    _rewrite(v1, drop=("sq_norms", "row_scale", "coarse_"), format_version=1)
    norev = tidx.save(str(tmp_path / "norev"))
    _rewrite(norev, drop=("rev_ids", "rev_lam", "rev_ptr"))
    for path in (v1, norev):
        g_j, x_j, _, _ = jsnap.load(path)
        g_t, x_t, _, _ = tsnap.load(path, device="cpu")
        tp.assert_graphs_equal(g_t, g_j, path)
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))
    g_t, x_t, _, _ = tsnap.load(v1, device="cpu")
    tp.assert_graphs_equal(tgraph.attach_sq_norms(tidx.graph, tidx.items), jidx.graph)
    g_t, _, _, _ = tsnap.load(norev, device="cpu")
    assert torch.equal(g_t.rev_ids, tgraph.rebuild_reverse(tidx.graph).rev_ids)
    back = TIndex.load(v1, device="cpu")
    assert back.coarse is not None and back.coarse.n_landmarks == 48
    res = back.search(torch.from_numpy(tp.int_data(4, D, seed=3)), 5)
    assert bool((res.seed_cell >= 0).all())


def test_refused_and_tolerated(churned, tmp_path):
    """A newer format and a manifest that disagrees with its payload are
    refused; a config field neither package knows is dropped."""
    _, tidx = churned
    newer = tidx.save(str(tmp_path / "newer"))
    _rewrite(newer, format_version=tsnap.FORMAT_VERSION + 1)
    with pytest.raises(ValueError, match="format_version"):
        tsnap.load(newer, device="cpu")
    torn = tidx.save(str(tmp_path / "torn"))
    with open(os.path.join(torn, tsnap.MANIFEST_NAME)) as f:
        man = json.load(f)
    man["arrays"]["nbr_ids"]["shape"] = [1, 1]
    _rewrite(torn, arrays=man["arrays"])
    with pytest.raises(ValueError, match="corrupt"):
        tsnap.load(torn, device="cpu")
    drift = tidx.save(str(tmp_path / "drift"))
    with open(os.path.join(drift, tsnap.MANIFEST_NAME)) as f:
        man = json.load(f)
    man["build_config"]["some_future_knob"] = 42
    _rewrite(drift, build_config=man["build_config"])
    _, _, cfg, _ = tsnap.load(drift, device="cpu")
    assert cfg == tidx.build_cfg
