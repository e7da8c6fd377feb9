"""Port NN-Descent (``core.nndescent``) against the JAX reference
(``dispatch="reference"``): the baseline build from replayed random lists,
the refinement sweep over a wave-built graph and the canonical λ, bit for
bit on integer-valued data; on N(0,1) rows λ is held to a float64 oracle
wherever no comparison falls within the fp32 tolerance of
``tests/test_precision.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro.core import nndescent as jnnd
from repro.core import search as jsearch
from repro_torch.core import construct as tconstruct
from repro_torch.core import nndescent as tnnd
from repro_torch.core import search as tsearch

torch.set_num_threads(2)

N, D, K = 600, 8, 8
CFG = dict(k=K, metric="l2", wave=64, lgd=True, beam=24, n_seeds=4, hash_slots=512,
           max_iters=32, n_seed_init=64)


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    with tp.compiled_reference():
        yield


@pytest.fixture(scope="module")
def data():
    return tp.int_data(N, D, seed=0)


NND = dict(k=K, metric="l2", max_iters=3, node_chunk=96)


def test_nndescent_build_matches_reference(data):
    x = data[:400]
    key = jax.random.PRNGKey(10)
    g_j, st_j = jnnd.build(jnp.asarray(x), jnnd.NNDescentConfig(dispatch="reference", **NND), key)
    g_t, st_t = tnnd.build(torch.from_numpy(x), tnnd.NNDescentConfig(**NND), tp.JaxDraws(key),
                           device="cpu")
    tp.assert_graphs_equal(g_t, g_j, "nndescent")
    assert st_t == st_j


def test_refine_and_recompute_lambda_match_reference(data):
    """Two join rounds over a wave-built graph, then the canonical λ."""
    g_j, _ = jconstruct.build(jnp.asarray(data), jconstruct.BuildConfig(dispatch="reference", **CFG),
                              jax.random.PRNGKey(1))
    gt = tp.to_torch_graph(g_j)
    want, c_want = jnnd.refine(g_j, jnp.asarray(data), "l2", rounds=2, node_chunk=96,
                               dispatch="reference")
    got, c_got = tnnd.refine(gt, torch.from_numpy(data), "l2", rounds=2, node_chunk=96)
    tp.assert_graphs_equal(got, want, "refine")
    assert c_got == c_want
    lam, comps = tnnd.recompute_lambda(got.nbr_ids, got.nbr_dist, torch.from_numpy(data), "l2",
                                       node_chunk=50)
    assert torch.equal(lam, got.nbr_lam) and comps > 0
    assert tnnd.refine(gt, torch.from_numpy(data), rounds=0) == (gt, 0)


def test_recompute_lambda_against_float64_oracle():
    """On N(0,1) rows λ counts the earlier members closer to j_i than v is,
    as float64 does wherever the two comparisons are not within the fp32
    tolerance."""
    x = tp.gauss_data(400, D, seed=11)  # the baseline test's shapes: one compile
    g_j, _ = jnnd.build(jnp.asarray(x), jnnd.NNDescentConfig(dispatch="reference", **NND),
                        jax.random.PRNGKey(12))
    ids, dist = np.array(g_j.nbr_ids), np.array(g_j.nbr_dist)
    lam, _ = tnnd.recompute_lambda(torch.from_numpy(ids), torch.from_numpy(dist),
                                   torch.from_numpy(x), "l2")
    x64 = x.astype(np.float64)
    vec = x64[np.clip(ids, 0, None)]
    dm = ((vec[:, :, None, :] - vec[:, None, :, :]) ** 2).sum(-1)  # (n, k, k)
    valid = (ids[:, :, None] >= 0) & (ids[:, None, :] >= 0) & np.triu(np.ones((K, K), bool), 1)
    margin = np.abs(dm - dist[:, None, :]) > 2e-4 * np.abs(dist[:, None, :]) + 2e-5
    occ = valid & (dm < dist[:, None, :])
    # rows with a comparison inside the tolerance are left out
    clear = (margin | ~valid).all(axis=(1, 2))
    want = np.where(ids >= 0, occ.sum(1), 0)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(lam.numpy()[clear], want[clear])


def test_nndescent_config_matches_reference_fields():
    ref_fields = {f.name for f in dataclasses.fields(jnnd.NNDescentConfig)}
    port_fields = {f.name for f in dataclasses.fields(tnnd.NNDescentConfig)}
    assert port_fields == ref_fields - {"use_pallas", "dispatch"}


def test_build_parallel_with_light_sub_builds_and_shallow_merge(data):
    """``build_parallel``'s ``sub_cfg`` (lighter sub-builds) and
    ``merge_scfg`` (a shallow merge search), with ``return_coarse`` under
    random seeding (no level): the same graph and stats as the reference."""
    key = jax.random.PRNGKey(20)
    light = dict(CFG, beam=16, max_iters=16)
    shallow = dict(k=K, beam=K, n_seeds=4, max_iters=8, hash_slots=512, use_lgd_mask=True)
    g_j, st_j, c_j = jconstruct.build_parallel(
        jnp.asarray(data), jconstruct.BuildConfig(dispatch="reference", **CFG), key, shards=2,
        sub_cfg=jconstruct.BuildConfig(dispatch="reference", **light),
        merge_scfg=jsearch.SearchConfig(dispatch="reference", **shallow), return_coarse=True)
    g_t, st_t, c_t = tconstruct.build_parallel(
        torch.from_numpy(data), tconstruct.BuildConfig(**CFG), tp.JaxDraws(key), shards=2,
        sub_cfg=tconstruct.BuildConfig(**light), merge_scfg=tsearch.SearchConfig(**shallow),
        return_coarse=True, device="cpu")
    tp.assert_graphs_equal(g_t, g_j, "light sub-builds")
    assert int(st_t.n_comps) == int(st_j.n_comps) and c_t is None and c_j is None
