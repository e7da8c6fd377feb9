"""Port recommender models: ``repro_torch.models.{common,embedding,recsys}``,
the recsys configs and registry, ``data.recsys_data`` and the parameter
carry of ``convert``, against the JAX package on the same numpy inputs.

The reference's parameters are carried across with
``convert.recsys_params_from_numpy``; MIND's fixed routing logits are the
reference's ``PRNGKey(7)`` draw, replayed (``torch_parity.mind_routing_init``).
Tolerance in fp32: rtol 1e-5, atol 1e-6 (the two packages sum products in
different orders); the CIN on N(0, 1) rows, whose sums of H·F products
cancel down to values far below their terms, to 1e-5 of its largest output
(``close_to_scale``).  Chunked scoring equals the whole batch's bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro import configs as jconfigs
from repro.data import recsys_data as jdata
from repro.models import common as jcommon
from repro.models import embedding as jemb
from repro.models import recsys as jrec
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import recsys_data as tdata
from repro_torch.models import common as tcommon
from repro_torch.models import embedding as temb
from repro_torch.models import recsys as trec

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
ARCHS = ("deepfm", "xdeepfm", "bst", "mind")


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_to_scale(got, want, rtol=RTOL):
    """Every element within ``rtol`` of the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rtol * np.abs(want).max())


def randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def configs_of(arch):
    return jconfigs.get(arch).smoke_config(), tconfigs.get(arch).smoke_config()


@functools.cache
def params_of(arch, seed=0):
    """The reference's parameters and the port's copy of them (shared by
    the tests, which only read them)."""
    jcfg, tcfg = configs_of(arch)
    pj = jrec.init_params(jax.random.PRNGKey(seed), jcfg)
    pt = convert.recsys_params_from_numpy(jax.tree.map(np.asarray, pj), tcfg)
    return pj, pt


def batch_of(cfg, B, seed=0):
    """A numpy batch of the arch's layout: ids drawn over the vocabulary,
    some history slots padding (-1)."""
    rs = np.random.RandomState(seed)
    if cfg.name in ("deepfm", "xdeepfm"):
        b = {"dense": rs.randn(B, cfg.n_dense).astype(np.float32),
             "sparse": rs.randint(0, cfg.vocab_per_field, (B, cfg.n_sparse)).astype(np.int32)}
    else:
        hist = rs.randint(0, cfg.vocab_per_field, (B, cfg.seq_len)).astype(np.int32)
        hist[rs.rand(B, cfg.seq_len) < 0.2] = -1
        b = {"hist": hist, "target": rs.randint(0, cfg.vocab_per_field, (B,)).astype(np.int32)}
    b["label"] = rs.randint(0, 2, (B,)).astype(np.float32)
    return b


def retrieval_batch_of(cfg, N, seed=0):
    rs = np.random.RandomState(seed)
    cand = rs.randint(0, cfg.vocab_per_field, (N,)).astype(np.int32)
    if cfg.name in ("deepfm", "xdeepfm"):
        return {"dense": rs.randn(1, cfg.n_dense).astype(np.float32),
                "sparse": rs.randint(0, cfg.vocab_per_field, (1, cfg.n_sparse)).astype(np.int32),
                "cand": cand}
    hist = rs.randint(0, cfg.vocab_per_field, (1, cfg.seq_len)).astype(np.int32)
    if cfg.name == "bst":
        return {"hist": hist, "cand": cand}
    return {"hist": hist, "candidates": rs.randn(N, cfg.embed_dim).astype(np.float32)}


def split(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


def test_norms_compute_in_fp32_and_cast_back():
    x, g, b = randn(5, 16, seed=1), randn(16, seed=2), randn(16, seed=3)
    (xj, xt), (gj, gt), (bj, bt) = both(x), both(g), both(b)
    close(tcommon.rms_norm(xt, gt), jcommon.rms_norm(xj, gj))
    close(tcommon.layer_norm(xt, gt, bt), jcommon.layer_norm(xj, gj, bj))
    xb = xt.bfloat16()
    assert tcommon.rms_norm(xb, gt).dtype == torch.bfloat16
    assert tcommon.layer_norm(xb, gt, bt).dtype == torch.bfloat16
    want = jcommon.layer_norm(xj.astype(jnp.bfloat16), gj, bj).astype(jnp.float32)
    close(tcommon.layer_norm(xb, gt, bt).float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("act", sorted(jcommon.ACTIVATIONS))
def test_activations(act):
    """``gelu`` is the tanh approximation, jax.nn.gelu's default."""
    xj, xt = both(randn(64, seed=4) * 3)
    close(tcommon.ACTIVATIONS[act](xt), jcommon.ACTIVATIONS[act](xj))


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(x)
    assert not torch.equal(tcommon.ACTIVATIONS["gelu"](x), exact)
    close(tcommon.ACTIVATIONS["gelu"](x), jax.nn.gelu(jnp.asarray(x.numpy()), approximate=True))


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_softmax_xent_masks_negative_labels(z_loss):
    logits = randn(6, 7, 11, seed=5) * 4
    labels = np.random.RandomState(6).randint(-1, 11, (6, 7)).astype(np.int32)
    (lj, lt), (yj, yt) = both(logits), both(labels)
    close(tcommon.softmax_xent(lt, yt, z_loss=z_loss), jcommon.softmax_xent(lj, yj, z_loss=z_loss))
    # all masked: 0 / max(0, 1)
    assert float(tcommon.softmax_xent(lt, torch.full_like(yt, -1))) == 0.0


def test_sigmoid_bce_and_count_params():
    logits = randn(50, seed=7) * 30  # large |x|: the stable form
    labels = (np.random.RandomState(8).rand(50) < 0.5).astype(np.float32)
    (lj, lt), (yj, yt) = both(logits), both(labels)
    close(tcommon.sigmoid_bce(lt, yt), jcommon.sigmoid_bce(lj, yj))
    for arch in ARCHS:
        pj, pt = params_of(arch)
        assert tcommon.count_params(pt) == jcommon.count_params(pj)


def test_initializers_draw_on_the_generator_and_keep_their_range():
    g = torch.Generator().manual_seed(0)
    w = tcommon.dense_init(g, (512, 256), scale=2.0)
    std = 2.0 / np.sqrt(512)
    assert w.shape == (512, 256) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    # a normal truncated at ±2 sigma keeps 0.8796 of its standard deviation
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    assert abs(float(w.mean())) < 0.01 * std
    again = tcommon.dense_init(torch.Generator().manual_seed(0), (512, 256), scale=2.0)
    assert torch.equal(w, again)
    e = tcommon.embed_init(g, (400, 64), torch.bfloat16, scale=0.05)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.05) < 0.002
    assert torch.equal(tcommon.zeros_init(g, (3, 2)), torch.zeros(3, 2))
    m = tcommon.mlp_stack(g, [8, 16, 1])
    assert sorted(m) == ["b0", "b1", "w0", "w1"] and m["w1"].shape == (16, 1)


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hash_rows", [0, 37])
def test_lookup_padding_and_hash(hash_rows):
    cfg_j = jemb.TableConfig(rows=10_000, dim=6, hash_rows=hash_rows)
    cfg_t = temb.TableConfig(rows=10_000, dim=6, hash_rows=hash_rows)
    table = randn(hash_rows or 10_000, 6, seed=9)
    ids = np.array([[0, 9_999, -1], [1234, 36, 37]], dtype=np.int32)
    (tj, tt), (ij, it) = both(table), both(ids)
    got = temb.lookup(tt, it, cfg_t)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jemb.lookup(tj, ij, cfg_j)))
    assert float(got[0, 2].abs().sum()) == 0.0
    np.testing.assert_array_equal(temb.lookup(tt, it).numpy() if not hash_rows else 0,
                                  np.asarray(jemb.lookup(tj, ij)) if not hash_rows else 0)


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", False), ("sum", True),
                                           ("mean", True)])
def test_embedding_bag(mode, weighted):
    table = randn(40, 6, seed=10)
    ids = np.array([[1, 2, 3, 4], [5, -1, -1, 5], [-1, -1, -1, -1], [39, 0, -1, 7]],
                   dtype=np.int32)
    w = np.random.RandomState(11).rand(4, 4).astype(np.float32) if weighted else None
    (tj, tt), (ij, it) = both(table), both(ids)
    got = temb.embedding_bag(tt, it, mode=mode, weights=None if w is None else torch.from_numpy(w))
    want = jemb.embedding_bag(tj, ij, mode=mode, weights=None if w is None else jnp.asarray(w))
    close(got, want)
    assert float(got[2].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="mode"):
        temb.embedding_bag(tt, it, mode="max")


def test_field_offset_ids_index_in_int64():
    """The CTR models' offset ids pass 2^31 / 2 at full width without
    wrapping: the offset and the lookup work in int64."""
    cfg = tconfigs.get("deepfm").full_config()
    ids = trec.field_ids(torch.full((1, cfg.n_sparse), cfg.vocab_per_field - 1,
                                     dtype=torch.int32), cfg)
    assert ids.dtype == torch.int64 and int(ids.max()) == cfg.total_rows - 1
    assert cfg.total_rows == 39_000_000


# ---------------------------------------------------------------------------
# interaction blocks
# ---------------------------------------------------------------------------


def test_fm_second_order():
    ej, et = both(randn(7, 5, 3, seed=12))
    close(trec.fm_second_order(et), jrec.fm_second_order(ej))


def test_cin_against_reference():
    jcfg, tcfg = configs_of("xdeepfm")
    pj, pt = params_of("xdeepfm")
    ej, et = both(randn(9, tcfg.n_sparse, tcfg.embed_dim, seed=13))
    close_to_scale(trec.cin(et, pt["cin"], tcfg.cin_layers),
                   jrec.cin(ej, pj["cin"], jcfg.cin_layers))


@pytest.mark.parametrize("chunk", [1, 2, 3, 5, 8])
def test_cin_chunked_equals_unchunked_bit_for_bit(chunk):
    _, tcfg = configs_of("xdeepfm")
    _, pt = params_of("xdeepfm")
    et = torch.from_numpy(randn(23, tcfg.n_sparse, tcfg.embed_dim, seed=14))
    whole = trec.cin(et, pt["cin"], tcfg.cin_layers, chunk=23)
    assert torch.equal(trec.cin(et, pt["cin"], tcfg.cin_layers, chunk=chunk), whole)


def test_row_slices_keep_two_rows():
    assert [(s.start, s.stop) for s in trec.row_slices(7, 3)] == [(0, 3), (3, 7)]
    assert [(s.start, s.stop) for s in trec.row_slices(6, 3)] == [(0, 3), (3, 6)]
    assert [(s.start, s.stop) for s in trec.row_slices(5, 1)] == [(0, 2), (2, 5)]
    assert [(s.start, s.stop) for s in trec.row_slices(1, 4)] == [(0, 1)]
    assert [(s.start, s.stop) for s in trec.row_slices(0, 4)] == [(0, 0)]


def test_bst_block_against_reference():
    jcfg, tcfg = configs_of("bst")
    pj, pt = params_of("bst")
    hj, ht = both(randn(6, tcfg.seq_len + 1, tcfg.embed_dim, seed=15))
    close(trec._bst_block(ht, pt["attn"], 0, tcfg.n_heads),
          jrec._bst_block(hj, pj["attn"], 0, jcfg.n_heads))


@pytest.mark.parametrize("S", [5, 8, 12])
def test_capsule_routing_with_replayed_logits(S):
    """The reference draws its routing logits from PRNGKey(7) for each
    history length; replayed, the port's interests follow to the tolerance
    (the port's own default draw differs, and so do its interests)."""
    _, tcfg = configs_of("mind")
    pj, pt = params_of("mind")
    D, K = tcfg.embed_dim, tcfg.n_interests
    emb = randn(4, S, D, seed=16)
    mask = np.random.RandomState(17).rand(4, S) < 0.8
    emb[~mask] = 0.0
    (ej, et), (mj, mt) = both(emb), both(mask)
    want = jrec.capsule_routing(ej, mj, pj["caps_bilinear"], K, tcfg.capsule_iters)
    got = trec.capsule_routing(et, mt, pt["caps_bilinear"], K, tcfg.capsule_iters,
                               routing_init=tp.mind_routing_init)
    close(got, want)
    own = trec.capsule_routing(et, mt, pt["caps_bilinear"], K, tcfg.capsule_iters)
    assert not np.allclose(own.numpy(), np.asarray(want), rtol=1e-2, atol=1e-3)


def test_default_routing_logits_are_fixed():
    a = trec.default_routing_init(20, 4)
    assert a.shape == (20, 4) and torch.equal(a, trec.default_routing_init(20, 4))
    assert a.device.type == "cpu"


# ---------------------------------------------------------------------------
# the four archs at smoke_config()
# ---------------------------------------------------------------------------


def routing(arch):
    return {"routing_init": tp.mind_routing_init} if arch == "mind" else {}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_scores(arch):
    jcfg, tcfg = configs_of(arch)
    pj, pt = params_of(arch)
    bj, bt = split(batch_of(tcfg, 33, seed=18))
    got = trec.serve_scores(pt, bt, tcfg, **routing(arch))
    assert got.shape == (33,) and bool(torch.isfinite(got).all())
    close(got, jrec.serve_scores(pj, bj, jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn(arch):
    jcfg, tcfg = configs_of(arch)
    pj, pt = params_of(arch)
    bj, bt = split(batch_of(tcfg, 40, seed=19))
    loss, aux = trec.loss_fn(pt, bt, tcfg, **routing(arch))
    want_loss, want_aux = jrec.loss_fn(pj, bj, jcfg)
    close(loss, want_loss)
    # the same hits: the two means of the 0/1 hits may round differently
    assert round(float(aux["acc"]) * 40) == round(float(want_aux["acc"]) * 40)


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_scorer(arch):
    """mind: ``retrieval_scores``; deepfm/xdeepfm: ``ctr_retrieval_scores``;
    bst: ``bst_retrieval_scores``."""
    jcfg, tcfg = configs_of(arch)
    pj, pt = params_of(arch)
    bj, bt = split(retrieval_batch_of(tcfg, 57, seed=20))
    if arch == "mind":
        got = trec.retrieval_scores(pt, bt["hist"], bt["candidates"], tcfg, **routing(arch))
        want = jrec.retrieval_scores(pj, bj["hist"], bj["candidates"], jcfg)
    elif arch == "bst":
        got, want = trec.bst_retrieval_scores(pt, bt, tcfg), jrec.bst_retrieval_scores(pj, bj, jcfg)
    else:
        got, want = trec.ctr_retrieval_scores(pt, bt, tcfg), jrec.ctr_retrieval_scores(pj, bj, jcfg)
    assert got.shape == (57,)
    close(got, want)


@pytest.mark.parametrize("chunk", [2, 5, 16])
def test_bst_retrieval_chunked_equals_unchunked_bit_for_bit(chunk):
    _, tcfg = configs_of("bst")
    _, pt = params_of("bst")
    _, bt = split(retrieval_batch_of(tcfg, 45, seed=21))
    whole = trec.bst_retrieval_scores(pt, bt, tcfg, chunk=45)
    assert torch.equal(trec.bst_retrieval_scores(pt, bt, tcfg, chunk=chunk), whole)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_scores_chunked_equals_unchunked_bit_for_bit(arch):
    _, tcfg = configs_of(arch)
    _, pt = params_of(arch)
    _, bt = split(batch_of(tcfg, 31, seed=22))
    whole = trec.serve_scores(pt, bt, tcfg, chunk=31)
    assert torch.equal(trec.serve_scores(pt, bt, tcfg, chunk=4), whole)
    if arch in ("deepfm", "xdeepfm"):
        _, rt = split(retrieval_batch_of(tcfg, 29, seed=23))
        whole = trec.ctr_retrieval_scores(pt, rt, tcfg, chunk=29)
        assert torch.equal(trec.ctr_retrieval_scores(pt, rt, tcfg, chunk=6), whole)


def test_ctr_retrieval_leaves_the_user_rows_unwritten():
    """The item goes into field 0 of a copy: the user's gathered rows, and
    the table, are as they were."""
    _, tcfg = configs_of("deepfm")
    _, pt = params_of("deepfm")
    before = pt["table"].clone()
    _, rt = split(retrieval_batch_of(tcfg, 12, seed=24))
    trec.ctr_retrieval_scores(pt, rt, tcfg, chunk=5)
    assert torch.equal(pt["table"], before)


def test_init_params_tree_matches_the_reference():
    for arch in ARCHS:
        jcfg, tcfg = configs_of(arch)
        pj = jax.tree.map(np.asarray, jrec.init_params(jax.random.PRNGKey(0), jcfg))
        pt = trec.init_params(torch.Generator().manual_seed(0), tcfg)
        pt = convert.recsys_params_to_numpy(pt)
        assert jax.tree.structure(pj) == jax.tree.structure(pt), arch
        for a, b in zip(jax.tree.leaves(pj), jax.tree.leaves(pt)):
            assert a.shape == b.shape and a.dtype == b.dtype, arch


def test_params_carry_both_ways_and_refuse_another_layout():
    pj, pt = params_of("xdeepfm")
    back = convert.recsys_params_to_numpy(pt)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, pj)), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    _, tcfg = configs_of("deepfm")
    with pytest.raises(ValueError, match="keys"):
        convert.recsys_params_from_numpy(back, tcfg)
    wide = dataclasses.replace(configs_of("xdeepfm")[1], embed_dim=4)
    with pytest.raises(ValueError, match="shape"):
        convert.recsys_params_from_numpy(back, wide)


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

PORTED = ("mixtral-8x7b", "arctic-480b", "stablelm-1.6b", "qwen2.5-3b", "gemma3-1b",
          "mace", "deepfm", "bst", "xdeepfm", "mind", "knn-lgd", "knn-olg")
NOT_PORTED = sorted(set(jconfigs.names()) - set(PORTED))


def as_dict(cfg):
    """A config's fields, a nested config (an LM's ``MoEConfig``) as its
    own fields: the two packages' dataclasses never compare equal."""
    d = dict(cfg.__dict__)
    for name in convert._DROPPED:  # the reference's engine selection
        d.pop(name, None)
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v for k, v in d.items()}


@pytest.mark.parametrize("arch", PORTED)
def test_registry_configs_equal_the_reference(arch):
    jm, tm = jconfigs.get(arch), tconfigs.get(arch)
    for fn in ("full_config", "smoke_config"):
        assert as_dict(getattr(tm, fn)()) == as_dict(getattr(jm, fn)()), (arch, fn)
    assert (tm.ARCH, tm.FAMILY, tm.SHAPES, tm.SKIP) == (jm.ARCH, jm.FAMILY, jm.SHAPES, jm.SKIP)


def test_registry_raises_for_an_unported_arch(monkeypatch):
    """Every arch is ported; an arch named in ``_NOT_PORTED`` would raise,
    naming its ROADMAP item."""
    assert tconfigs._NOT_PORTED == {}
    monkeypatch.setitem(tconfigs._NOT_PORTED, "gemma3-1b", "13c")
    with pytest.raises(NotImplementedError, match="item 13c"):
        tconfigs.get("gemma3-1b")


def test_registry_names_and_cells():
    assert len(NOT_PORTED) == 0
    assert tconfigs.names() == jconfigs.names()
    assert tconfigs.names(include_knn=False) == jconfigs.names(include_knn=False)
    assert tconfigs.names(include_knn=False)[:6] == [
        "mixtral-8x7b", "arctic-480b", "stablelm-1.6b", "qwen2.5-3b", "gemma3-1b", "mace"]
    assert tconfigs.all_cells(include_knn=True) == jconfigs.all_cells(include_knn=True)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get("no-such-arch")


# ---------------------------------------------------------------------------
# recsys_data
# ---------------------------------------------------------------------------


def test_zipf_ids_follow_the_reference_distribution():
    """Same float32 transform of a uniform: the share of ids under each
    threshold agrees with the reference's within sampling noise."""
    n, vocab = 200_000, 1_000_000
    got = tdata.zipf_ids(torch.Generator().manual_seed(0), (n,), vocab).numpy()
    want = np.asarray(jdata.zipf_ids(jax.random.PRNGKey(0), (n,), vocab))
    assert got.dtype == want.dtype == np.int32
    assert got.min() >= 0 and got.max() < vocab
    for t in (1, 10, 1_000, 100_000, 500_000):
        assert abs((got < t).mean() - (want < t).mean()) < 0.005, t


def test_batches_have_the_reference_layout():
    g = torch.Generator().manual_seed(1)
    key = jax.random.PRNGKey(1)
    for got, want in (
        (tdata.ctr_batch(g, 64, 7, 300), jdata.ctr_batch(key, 64, 7, 300)),
        (tdata.behavior_batch(g, 64, 9, 300), jdata.behavior_batch(key, 64, 9, 300)),
        (tdata.retrieval_batch(g, 50, 16, seq_len=12, vocab=300),
         jdata.retrieval_batch(key, 50, 16, seq_len=12, vocab=300)),
    ):
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        if "label" in got:
            assert set(np.unique(got["label"].numpy())) <= {0.0, 1.0}
    again = tdata.ctr_batch(torch.Generator().manual_seed(1), 64, 7, 300)
    assert torch.equal(again["sparse"], tdata.ctr_batch(torch.Generator().manual_seed(1),
                                                         64, 7, 300)["sparse"])


def test_port_batches_drive_the_port_models():
    """A batch from the port's generators through each arch's serve path."""
    g = torch.Generator().manual_seed(2)
    for arch in ARCHS:
        cfg = tconfigs.get(arch).smoke_config()
        pt = trec.init_params(g, cfg)
        if arch in ("deepfm", "xdeepfm"):
            b = tdata.ctr_batch(g, 16, cfg.n_sparse, cfg.vocab_per_field)
        else:
            b = tdata.behavior_batch(g, 16, cfg.seq_len, cfg.vocab_per_field)
        s = trec.serve_scores(pt, b, cfg)
        assert s.shape == (16,) and bool(((s > 0) & (s < 1)).all()), arch
