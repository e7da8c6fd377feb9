"""The reference's build variants in the port, against the JAX reference
(``dispatch="reference"``) on the same numpy inputs with replayed keys.

* ``intra_wave=False``: no W x W tile, wave pairs take D = +inf in the λ
  rules; W=1 (the paper's sequential limit, the size of
  ``tests/test_core.py``'s) and W=64 builds equal the reference's bit for
  bit, counters too.
* ``data_bf16``: a dataset stored bfloat16 with fp32 accumulation; W=64
  builds equal the reference's on integer rows, and on N(0,1) rows reach
  its recall; bf16 snapshots load across the two packages both ways; an
  ``OnlineIndex`` keeps its items bf16 through add/remove/compact, equal to
  the reference's.
* The compressed pairwise (bf16, int8, PQ-ADC x side) equals the
  reference's ``ops.pairwise_distance(precision=...)`` to the tolerances of
  ``tests/test_precision.py``.
* ``convert`` carries both fields across.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro.index import OnlineIndex as JIndex
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core import construct as tconstruct
from repro_torch.core import graph as tgraph
from repro_torch.core.draws import TorchDraws
from repro_torch.index import OnlineIndex as TIndex
from repro_torch.kernels import ops as tops

torch.set_num_threads(2)

SMALL = dict(k=10, wave=64, beam=20, n_seeds=4, lgd=True, max_iters=30)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


def _build_both(x_j, x_t, seed, **kw):
    g_j, st_j = jconstruct.build(x_j, jconstruct.BuildConfig(dispatch="reference", **kw),
                                 jax.random.PRNGKey(seed))
    g_t, st_t = tconstruct.build(x_t, tconstruct.BuildConfig(**kw), device="cpu",
                                 seed_fn=tp.build_seed_fn(jax.random.PRNGKey(seed), kw["n_seeds"]))
    return (g_j, st_j), (g_t, st_t)


def _assert_same_build(built, err):
    (g_j, st_j), (g_t, st_t) = built
    tp.assert_graphs_equal(g_t, g_j, err)
    assert int(st_t.n_comps) == int(st_j.n_comps), err
    assert int(st_t.n_inserted_edges) == int(st_j.n_inserted_edges), err
    assert st_t.n_waves == int(st_j.n_waves), err


@pytest.mark.parametrize("wave,n,lgd", [(1, 300, True), (64, 500, True), (64, 500, False)])
def test_no_intra_wave_tile_bit_identical(wave, n, lgd):
    x = tp.int_data(n, 12, seed=4)
    kw = dict(SMALL, wave=wave, lgd=lgd, intra_wave=False, n_seed_init=64)
    if wave == 1:
        kw.update(beam=16, max_iters=16, hash_slots=256)
    built = _build_both(jnp.asarray(x), torch.from_numpy(x), 3, **kw)
    _assert_same_build(built, f"intra_wave=False W={wave}")


def test_intra_wave_changes_the_commit():
    """The tile is what lets a wave's rows find each other: without it a
    W=64 build charges no tile pairs and links fewer wave rows."""
    x = torch.from_numpy(tp.int_data(400, 12, seed=4))
    seed_fn = lambda wave, pos, W, n_valid: TorchDraws(wave).randint((W, 4), n_valid)
    cfg = tconstruct.BuildConfig(**SMALL)
    g_on, st_on = tconstruct.build(x, cfg, seed_fn=seed_fn, device="cpu")
    g_off, st_off = tconstruct.build(x, dataclasses.replace(cfg, intra_wave=False),
                                     seed_fn=seed_fn, device="cpu")
    assert int(st_on.n_comps) > int(st_off.n_comps)
    assert not torch.equal(g_on.nbr_ids, g_off.nbr_ids)


def test_bf16_build_bit_identical_on_integer_data():
    x = tp.int_data(500, 16, seed=2)
    kw = dict(SMALL, data_bf16=True)
    built = _build_both(jnp.asarray(x).astype(jnp.bfloat16),
                        torch.from_numpy(x).to(torch.bfloat16), 5, **kw)
    _assert_same_build(built, "data_bf16")
    # the flag alone stores the rows bf16: fp32 rows give the same graph
    g_t2, _ = tconstruct.build(torch.from_numpy(x), tconstruct.BuildConfig(**kw), device="cpu",
                               seed_fn=tp.build_seed_fn(jax.random.PRNGKey(5), kw["n_seeds"]))
    assert torch.equal(g_t2.nbr_ids, built[1][0].nbr_ids)


def test_bf16_build_gaussian_recall():
    """N(0,1) rows stored bf16: fp32 sums of the widened rows run in another
    order in each package, so the graphs may part at near-ties; recall@10
    stays within 0.01 of the reference's and every invariant holds."""
    x = tp.gauss_data(1500, 20, seed=0)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    kw = dict(k=16, wave=64, beam=32, n_seeds=8, lgd=True, data_bf16=True)
    (g_j, st_j), (g_t, st_t) = _build_both(jnp.asarray(xb).astype(jnp.bfloat16),
                                           torch.from_numpy(xb).to(torch.bfloat16), 0, **kw)
    assert g_t.sq_norms.dtype == torch.float32
    np.testing.assert_allclose(g_t.sq_norms.numpy(), np.asarray(g_j.sq_norms), rtol=1e-6)
    r_t, r_j = tp.graph_recalls(xb, g_t, g_j)
    assert abs(r_t - r_j) <= 0.01, (r_t, r_j)
    assert all(bool(v.all()) for v in tgraph.graph_invariants_ok(g_t).values())


def test_compressed_pairwise_matches_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(300, 32).astype(np.float32)
    q = rs.randn(17, 32).astype(np.float32)
    for precision in ("bf16", "int8", "pq"):
        enc_j, enc_t = tp.encode_both(x, precision)
        for metric in ("l2", "ip", "cosine", "l1"):
            if precision == "pq" and metric == "l1":
                continue
            want = np.asarray(jops.pairwise_distance(jnp.asarray(q), jnp.asarray(x), metric,
                                                     dispatch="reference", enc=enc_j,
                                                     precision=precision))
            got = tops.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), metric,
                                         enc=enc_t, precision=precision).numpy()
            atol = {"l2": 0.05, "cosine": 0.02, "ip": 0.05, "l1": 0.05}[metric]
            np.testing.assert_allclose(got, want, rtol=0.02, atol=atol,
                                       err_msg=f"{precision} {metric}")
    # fp32 (or no table) is the exact path
    exact = tops.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x), "l2",
                                   enc=enc_t, precision="fp32")
    assert torch.equal(exact, tops.pairwise_distance(torch.from_numpy(q), torch.from_numpy(x)))


def test_convert_carries_intra_wave_and_data_bf16():
    ref = jconstruct.BuildConfig(k=12, wave=128, intra_wave=False, data_bf16=True,
                                 dispatch="reference")
    cfg = convert.build_config_from_dict(ref.__dict__)
    assert (cfg.intra_wave, cfg.data_bf16) == (False, True)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    back = jconstruct.BuildConfig(**dataclasses.asdict(cfg))
    assert (back.intra_wave, back.data_bf16) == (False, True)


# --------------------------------------------------------------------------
# bf16 items in the online index and its snapshots
# --------------------------------------------------------------------------

N, D = 500, 8
CFG = dict(k=8, metric="l2", wave=64, lgd=True, beam=24, n_seeds=4, hash_slots=512,
           max_iters=32, data_bf16=True)


def _items_equal(tidx, jidx, err):
    assert tidx.items.dtype == torch.bfloat16, err
    assert jidx.items.dtype == jnp.bfloat16, err
    np.testing.assert_array_equal(tidx.items.float().numpy(),
                                  np.asarray(jidx.items.astype(jnp.float32)), err_msg=err)
    tp.assert_graphs_equal(tidx.graph, jidx.graph, err)
    assert tidx.free_ids == tuple(int(i) for i in jidx.free_ids), err


@pytest.fixture(scope="module")
def bf16_indexes():
    x = tp.int_data(N, D, seed=0)
    key = jax.random.PRNGKey(1)
    jidx = JIndex.build(jnp.asarray(x).astype(jnp.bfloat16),
                        jconstruct.BuildConfig(dispatch="reference", **CFG), key=key,
                        capacity=N + 64)
    tidx = TIndex.build(torch.from_numpy(x), tconstruct.BuildConfig(**CFG), device="cpu",
                        capacity=N + 64, seed_fn=tp.build_seed_fn(key, CFG["n_seeds"]))
    _items_equal(tidx, jidx, "build")
    return jidx, tidx


def test_online_index_keeps_bf16_through_churn(bf16_indexes):
    jidx, tidx = bf16_indexes
    rows = tp.int_data(40, D, seed=9)
    key = jax.random.PRNGKey(2)
    jidx.add(jnp.asarray(rows), key=key, flush=True)
    tidx.add(torch.from_numpy(rows), flush=True, seed_fn=tp.build_seed_fn(key, CFG["n_seeds"]))
    _items_equal(tidx, jidx, "add")
    victims = np.arange(0, 120, 3, dtype=np.int32)
    jidx.remove(jnp.asarray(victims))
    tidx.remove(torch.from_numpy(victims))
    _items_equal(tidx, jidx, "remove")
    jidx.compact()
    tidx.compact()
    _items_equal(tidx, jidx, "compact")
    q = tp.int_data(8, D, seed=11)
    tp.search_both(jidx, tidx, q, 5, seed=3)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bf16_snapshot_across_packages(bf16_indexes, tmp_path, writer):
    jidx, tidx = bf16_indexes
    path = str(tmp_path / "snap")
    if writer == "reference":
        jidx.save(path)
        got = TIndex.load(path, device="cpu")
        _items_equal(got, jidx, "reference -> port")
        assert got.build_cfg.data_bf16
    else:
        tidx.save(path)
        got = JIndex.load(path)
        _items_equal(tidx, got, "port -> reference")
        assert got.build_cfg.data_bf16
