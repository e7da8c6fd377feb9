"""Port graph layer: brute force, the exact seed graph, the batched merge,
reverse-list appends and graph maintenance against the JAX reference, and
builds seeded from a torch generator.

Integer-valued data keeps the sums exact, so every array must match bit for
bit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_parity as tp
from repro.core import brute as jbrute
from repro.core import construct as jconstruct
from repro.core import graph as jgraph
from repro.core import merge as jmerge
from repro_torch import convert
from repro_torch.core import brute as tbrute
from repro_torch.core import construct as tconstruct
from repro_torch.core import graph as tgraph
from repro_torch.core import merge as tmerge

torch.set_num_threads(2)


@pytest.mark.parametrize("lgd", [False, True])
def test_build_olg_and_lgd_from_generator(lgd):
    """Default entry points (a torch generator): both algorithms build a
    valid graph; OLG carries no λ."""
    x = torch.from_numpy(tp.gauss_data(600, 8, seed=2))
    cfg = tconstruct.BuildConfig(k=10, wave=128, lgd=lgd, beam=24, n_seeds=4, max_iters=30)
    g, st = tconstruct.build(x, cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    truth, _ = tbrute.brute_force_knn(x, x, 10, exclude_ids=torch.arange(600, dtype=torch.int32),
                                      device="cpu")
    assert tbrute.recall_at_k(g.nbr_ids, truth, 10) >= 0.9
    assert all(bool(v.all()) for v in tgraph.graph_invariants_ok(g).values())
    assert st.n_waves == -(-(600 - 256) // 128)
    assert bool((g.nbr_lam > 0).any()) == lgd


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
def test_brute_force_matches(metric):
    """Tiles cross the end ragged (tile 64 over n=150) under the n_valid,
    alive and exclude masks; ties and padding resolve as the reference."""
    x = tp.int_data(150, 6, seed=4, high=6)
    q = x[:20]
    alive = np.random.RandomState(5).rand(150) < 0.8
    kw = dict(n_valid=140, tile=64)
    want = jbrute.brute_force_knn(
        jnp.asarray(x), jnp.asarray(q), 12, metric, alive=jnp.asarray(alive),
        exclude_ids=jnp.arange(20, dtype=jnp.int32), **kw,
    )
    got = tbrute.brute_force_knn(
        torch.from_numpy(x), torch.from_numpy(q), 12, metric, alive=torch.from_numpy(alive),
        exclude_ids=torch.arange(20, dtype=torch.int32), device="cpu", **kw,
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_seed,k", [(40, 8), (6, 8)])
def test_exact_seed_graph_matches(n_seed, k):
    x = tp.int_data(60, 5, seed=6)
    want = tp.jax_exact_seed_graph(jnp.asarray(x), n_seed, k, "l2")
    got = tbrute.exact_seed_graph(torch.from_numpy(x), n_seed, k, "l2", device="cpu")
    tp.assert_graphs_equal(got, want)


def test_merge_candidates_and_append_reverse_match():
    rng = np.random.RandomState(7)
    cap, k, R, T = 30, 5, 6, 90
    ids = np.sort(rng.randint(0, cap, (cap, k)), 1).astype(np.int32)
    dist = np.sort(rng.randint(1, 40, (cap, k)), 1).astype(np.float32)
    ids[:, -1], dist[:, -1] = -1, np.inf
    lam = rng.randint(0, 3, (cap, k)).astype(np.int32)
    v = rng.randint(-1, cap, T).astype(np.int32)
    q = rng.randint(0, cap, T).astype(np.int32)
    d = rng.randint(0, 45, T).astype(np.float32)
    v[5:9], q[5:9] = 3, 7  # exact (v, q) duplicates
    want = jax.jit(jmerge.merge_candidates)(*map(jnp.asarray, (ids, dist, lam, v, q, d)))
    got = tmerge.merge_candidates(*map(torch.from_numpy, (ids, dist, lam, v, q, d)))
    for name in want._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name)

    rev = rng.randint(-1, cap, (cap, R)).astype(np.int32)
    rlam = rng.randint(0, 3, (cap, R)).astype(np.int32)
    ptr = rng.randint(0, 9, cap).astype(np.int32)
    member = np.concatenate([rng.randint(-1, cap, T), np.full(10, 4)]).astype(np.int32)
    owner = rng.randint(0, cap, T + 10).astype(np.int32)  # member 4: > R appends
    lam_b = rng.randint(0, 4, T + 10).astype(np.int32)
    want = jax.jit(jmerge.append_reverse)(*map(jnp.asarray, (rev, rlam, ptr, owner, member, lam_b)))
    got = tmerge.append_reverse(*map(torch.from_numpy, (rev, rlam, ptr, owner, member, lam_b)))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_graph_maintenance_matches():
    """rebuild_reverse, the two caches (``row_scales`` keeps the float32
    reciprocal multiply) and the invariant checks."""
    # quarter-integers: sums of squares stay exact, the scales are not
    x = tp.int_data(40, 7, seed=9, high=40) / 4.0 - 5.0
    g_j = tp.jax_exact_seed_graph(jnp.asarray(x), 30, 6, "l2")
    g_j = g_j._replace(alive=g_j.alive.at[2].set(False))
    g_t = tp.to_torch_graph(g_j)
    tp.assert_graphs_equal(tgraph.rebuild_reverse(g_t), jax.jit(jgraph.rebuild_reverse)(g_j))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tgraph.row_scales(xt).numpy(), np.asarray(jgraph.row_scales(jnp.asarray(x))))
    tp.assert_graphs_equal(
        tgraph.attach_sq_norms(g_t, xt), jax.jit(jgraph.attach_sq_norms)(g_j, jnp.asarray(x)))
    got = tgraph.graph_invariants_ok(g_t)
    want = jax.jit(jgraph.graph_invariants_ok)(g_j)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    assert not bool(got["live_neighbors"].all())  # row 2 died under its neighbours


def test_build_config_from_reference_dict():
    ref = jconstruct.BuildConfig(k=12, wave=128, beam=30, dispatch="reference")
    cfg = convert.build_config_from_dict(ref.__dict__)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    # compressed precisions, bf16 storage, the tile switch and coarse
    # seeding are carried
    assert convert.build_config_from_dict(
        dataclasses.replace(ref, precision="int8").__dict__).precision == "int8"
    bf16 = convert.build_config_from_dict(
        dataclasses.replace(ref, data_bf16=True, intra_wave=False).__dict__)
    assert (bf16.data_bf16, bf16.intra_wave) == (True, False)
    coarse = dataclasses.replace(ref, seed_mode="coarse", coarse_landmarks=77, coarse_members=5,
                                 coarse_top=3)
    cfg = convert.build_config_from_dict(coarse.__dict__)
    for name in ("seed_mode", "coarse_landmarks", "coarse_members", "coarse_top"):
        assert getattr(cfg, name) == getattr(coarse, name), name
    jscfg, tscfg = coarse.search_config(), cfg.search_config()
    for name in ("seed_mode", "coarse_top", "coarse_beam", "coarse_iters"):
        assert getattr(tscfg, name) == getattr(jscfg, name), name


def test_build_config_round_trips_pq_rerank_factor():
    """``rerank_factor`` used to be dropped silently: a pq config carried
    across must search with the reference's re-rank width."""
    ref = jconstruct.BuildConfig(k=12, precision="pq", rerank_factor=7, dispatch="reference")
    cfg = convert.build_config_from_dict(ref.__dict__)
    assert (cfg.precision, cfg.rerank_factor) == ("pq", 7)
    jscfg, tscfg = ref.search_config(), cfg.search_config()
    for name in ("k", "beam", "n_seeds", "hash_slots", "max_iters", "metric",
                 "use_lgd_mask", "precision", "rerank_factor"):
        assert getattr(tscfg, name) == getattr(jscfg, name), name
