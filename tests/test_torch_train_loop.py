"""Port train steps (``repro_torch.train.train_loop``), the gradient
compressor (``train.compress``) and the loader (``data.loader``) against the
JAX package on the same numpy inputs.

* ``make_train_step`` on the four recommender smoke configs, parameters
  carried from the reference (MIND's PRNGKey(7) routing logits replayed), at
  ``accum_steps`` 1 and 4: loss and grad_norm of 3 steps (SGD and AdamW)
  and, under SGD, every parameter after them, within rtol 1e-5, atol 1e-6
  of the reference's jitted step; each arch's gradients against
  ``jax.value_and_grad``.
* ``compress``/``decompress`` bit for bit.
* The two-level data-parallel step: 4 gloo ranks on the CPU
  (``tests/torch_train_world.py``) against the reference's ``shard_map``
  over a (2, 2) ("pod", "data") mesh of 4 host devices, both started
  together, on the reference test's linear problem (SGD lr 0.15): the
  parameters within rtol 1e-6, compressed and uncompressed, equal on every
  rank.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro import configs as jconfigs
from repro.data import loader as jloader
from repro.models import recsys as jrec
from repro.train import compress as jcomp
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data import loader as tloader
from repro_torch.models import recsys as trec
from repro_torch.train import compress as tcomp
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
RTOL, ATOL = 1e-5, 1e-6
ARCHS = ("deepfm", "xdeepfm", "bst", "mind")
B, STEPS = 16, 3


def batch_of(cfg, seed):
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


def leaves_np(tree):
    return [np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)
            for x in jax.tree_util.tree_leaves(
                jax.tree.map(lambda t: t.detach().numpy() if torch.is_tensor(t) else t, tree))]


def assert_close_trees(got, want, rtol=RTOL, atol=ATOL):
    g, w = leaves_np(got), leaves_np(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def carried(arch, seed=0):
    jcfg, tcfg = jconfigs.get(arch).smoke_config(), tconfigs.get(arch).smoke_config()
    pj = jrec.init_params(jax.random.PRNGKey(seed), jcfg)
    pt = convert.recsys_params_from_numpy(jax.tree.map(np.asarray, pj), tcfg)
    return jcfg, tcfg, pj, pt


def losses(jcfg, tcfg):
    return (lambda p, b: jrec.loss_fn(p, b, jcfg),
            lambda p, b: trec.loss_fn(p, b, tcfg, routing_init=tp.mind_routing_init))


@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, opt, accum):
    """Three steps: the metrics of every step and the optimizer state
    within rtol 1e-5, atol 1e-6, and every parameter within rtol 1e-5 and,
    under SGD (where the parameters carry the gradients linearly), atol
    1e-6.  Under AdamW the parameters' atol is 1e-3 of the learning rate a
    step: its m/√v turns a gradient that cancels to ~1e-8 (a table row two
    histories share) into a unit-size step, so the last-bit rounding of
    such a gradient moves the parameter by up to 1e-3 of the learning
    rate, where a wrong update moves it by the learning rate."""
    jcfg, tcfg, pj, pt = carried(arch)
    jo = jopt.OptConfig(name=opt, lr=0.1 if opt == "sgd" else 3e-3)
    to = topt.OptConfig(**jo.__dict__)
    jl, tl = losses(jcfg, tcfg)
    jstep = jax.jit(jloop.make_train_step(jl, jo, accum_steps=accum))
    tstep = tloop.make_train_step(tl, to, accum_steps=accum)
    sj, st = jopt.init_opt_state(pj, jo), topt.init_opt_state(pt, to)
    for i in range(STEPS):
        bn = batch_of(tcfg, i)
        pj, sj, mj = jstep(pj, sj, {k: jnp.asarray(v) for k, v in bn.items()})
        pt, st, mt = tstep(pt, st, {k: torch.from_numpy(v) for k, v in bn.items()})
        assert set(mt) == set(mj)
        for k in mj:
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {k}")
    assert_close_trees(pt, pj, atol=ATOL if opt == "sgd" else 1e-3 * jo.lr * STEPS)
    assert_close_trees(st, sj)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    """``value_and_grad`` against ``jax.value_and_grad``: the loss, the aux
    metrics and the gradient of every parameter, the embedding tables' dense
    gradients included (zero on the rows the batch does not read)."""
    jcfg, tcfg, pj, pt = carried(arch, seed=2)
    jl, tl = losses(jcfg, tcfg)
    bn = batch_of(tcfg, 9)
    (lj, mj), gj = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        pj, {k: jnp.asarray(v) for k, v in bn.items()})
    (lt, mt), gt = tloop.value_and_grad(tl, pt, {k: torch.from_numpy(v) for k, v in bn.items()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL, atol=ATOL)
    assert float(mt["acc"]) == float(mj["acc"])
    assert_close_trees(gt, gj)
    assert gt["table"].shape == pt["table"].shape and not gt["table"].is_sparse
    ids = bn["sparse"] if "sparse" in bn else np.concatenate([bn["hist"].ravel(), bn["target"]])
    if "sparse" in bn:
        ids = (bn["sparse"] + np.arange(tcfg.n_sparse) * tcfg.vocab_per_field).ravel()
    untouched = np.setdiff1d(np.arange(gt["table"].shape[0]), ids)
    assert float(gt["table"][torch.from_numpy(untouched)].abs().max()) == 0.0


def test_accumulation_splits_contiguous_microbatches():
    """Four microbatches of the quadratic problem (the reference's own
    check): the accumulated step equals the full batch's to rtol 1e-5,
    atol 1e-6, and equals the mean of the four contiguous quarters' grads."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(32, 8).astype(np.float32))
    y = x @ torch.from_numpy(rs.randn(8, 4).astype(np.float32))

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2), {}

    params = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}
    cfg = topt.OptConfig(name="sgd", lr=0.1, grad_clip=0.0)
    st = topt.init_opt_state(params, cfg)
    p1, _, m1 = tloop.make_train_step(loss, cfg)(params, st, {"x": x, "y": y})
    p4, _, m4 = tloop.make_train_step(loss, cfg, accum_steps=4)(params, st, {"x": x, "y": y})
    np.testing.assert_allclose(p4["w"].numpy(), p1["w"].numpy(), rtol=1e-5, atol=1e-6)
    quarters = [tloop.value_and_grad(loss, params, {"x": x[i:i + 8], "y": y[i:i + 8]})[1]
                for i in range(0, 32, 8)]
    mean_w = sum(q["w"] for q in quarters) / 4
    assert torch.equal(p4["w"], params["w"] - 0.1 * mean_w)
    with pytest.raises(ValueError, match="microbatches"):
        tloop.make_train_step(loss, cfg, accum_steps=3)(params, st, {"x": x, "y": y})


def test_eval_step_matches_the_reference():
    jcfg, tcfg = jconfigs.get("deepfm").smoke_config(), tconfigs.get("deepfm").smoke_config()
    pj = jrec.init_params(jax.random.PRNGKey(1), jcfg)
    pt = convert.recsys_params_from_numpy(jax.tree.map(np.asarray, pj), tcfg)
    bn = batch_of(tcfg, 5)
    mj = jloop.make_eval_step(lambda p, b: jrec.loss_fn(p, b, jcfg))(
        pj, {k: jnp.asarray(v) for k, v in bn.items()})
    mt = tloop.make_eval_step(lambda p, b: trec.loss_fn(p, b, tcfg))(
        pt, {k: torch.from_numpy(v) for k, v in bn.items()})
    assert set(mt) == set(mj) == {"loss", "acc"}
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL, atol=ATOL)
    assert not mt["loss"].requires_grad


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((128,), 1.0), ((7, 33), 1e-3), ((5,), 0.0)])
def test_compress_is_bit_identical(shape, scale):
    rs = np.random.RandomState(len(shape))
    g = (scale * rs.randn(*shape)).astype(np.float32)
    e = (0.01 * rs.randn(*shape)).astype(np.float32)
    # values landing on a half quantum, where round-half-to-even decides
    if scale:
        x = np.abs(g + e).max()
        g.reshape(-1)[:3] = np.float32(x / 127.0) * np.float32([2.5, -3.5, 0.5]) - e.reshape(-1)[:3]
    qj, sj, ej = jcomp.compress(jnp.asarray(g), jnp.asarray(e))
    qt, s_t, et = tcomp.compress(torch.from_numpy(g), torch.from_numpy(e))
    assert qt.dtype == torch.int8
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(s_t.numpy(), np.asarray(sj))
    assert np.array_equal(et.numpy(), np.asarray(ej))
    assert np.array_equal(tcomp.decompress(qt, s_t).numpy(),
                          np.asarray(jcomp.decompress(qj, sj)))


def test_error_feedback_unbiased_over_steps():
    """The cumulative applied update converges to the cumulative gradient
    (the reference's property, ``tests/test_train.py``)."""
    rs = np.random.RandomState(0)
    err, applied, total = torch.zeros(64), torch.zeros(64), torch.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rs.randn(64).astype(np.float32))
        q, s, err = tcomp.compress(g, err)
        applied += tcomp.decompress(q, s)
        total += g
    assert float(torch.linalg.norm(applied - total) / torch.linalg.norm(total)) < 0.05


def test_error_state_and_pod_state_are_zeros():
    p = {"w": torch.ones(3, 2), "m": {"b": torch.ones(5)}}
    for st in (tcomp.init_error_state(p), tloop.init_pod_error_state(p)):
        assert st["w"].shape == (3, 2) and st["m"]["b"].shape == (5,)
        assert st["w"].dtype == torch.float32 and float(st["w"].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


def test_lm_tokens_equal_the_reference_on_its_draws():
    batch, seq, vocab = 4, 32, 1000
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    ku, kz = jax.random.split(key)
    u = np.asarray(jax.random.uniform(ku, (batch, seq)))
    sel = np.asarray(jax.random.bernoulli(kz, 0.5, (batch, seq)))
    want = jloader.lm_batches(batch, seq, vocab, seed=3).batch(7)["tokens"]
    got = tloader.lm_tokens(torch.from_numpy(u.copy()), torch.from_numpy(sel.copy()), vocab)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_loader_batches_are_a_pure_function_of_seed_and_step():
    spec = tloader.lm_batches(4, 16, 100, seed=5, device="cpu")
    a, b = spec.batch(3), tloader.lm_batches(4, 16, 100, seed=5, device="cpu").batch(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(spec.batch(4)["tokens"], a["tokens"])
    assert not torch.equal(tloader.lm_batches(4, 16, 100, seed=6, device="cpu").batch(3)["tokens"],
                           a["tokens"])
    it = iter(spec)
    assert torch.equal(next(it)["tokens"], spec.batch(0)["tokens"])
    assert torch.equal(next(it)["tokens"], spec.batch(1)["tokens"])
    assert tloader.step_seed(5, 3) != tloader.step_seed(3, 5)
    # the CPU generator keeps 32 bits of its seed: every step's must differ there
    seeds = {tloader.step_seed(5, s) & 0xFFFFFFFF for s in range(100_000)}
    assert len(seeds) == 100_000


def test_vector_waves_equal_the_reference():
    x = np.arange(23 * 2, dtype=np.float32).reshape(23, 2)
    want = [(p, np.asarray(w)) for p, w in jloader.vector_waves(jnp.asarray(x), 5, start=2)]
    got = [(p, w.numpy()) for p, w in tloader.vector_waves(torch.from_numpy(x), 5, start=2)]
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))


# ---------------------------------------------------------------------------
# the two-level data-parallel step: 4 gloo ranks against the (2, 2) mesh
# ---------------------------------------------------------------------------

REF_SHARDED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.kernels import compat
from repro.train import optimizer as opt_lib, train_loop

inp = dict(np.load(sys.argv[1]))
mesh = compat.make_mesh((2, 2), ("pod", "data"))
ocfg = opt_lib.OptConfig(name="sgd", lr=0.15, grad_clip=0.0)

def loss_fn(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean((pred - batch["y"]) ** 2), {}

out = {}
for compress in (True, False):
    p = {"w": jnp.zeros((16, 4))}
    opt = opt_lib.init_opt_state(p, ocfg)
    err = train_loop.init_pod_error_state(p, mesh)
    step = jax.jit(train_loop.make_sharded_train_step(loss_fn, ocfg, mesh, compress_pod=compress))
    with mesh:
        for i in range(int(inp["steps"])):
            batch = {"x": jnp.asarray(inp["x"]), "y": jnp.asarray(inp["y"])}
            p, opt, err, m = step(p, opt, err, batch)
    tag = "comp" if compress else "full"
    out[tag + "_w"], out[tag + "_loss"] = np.asarray(p["w"]), np.float32(m["loss"])
    out[tag + "_err"] = np.asarray(err["w"])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    rs = np.random.RandomState(0)
    w_true = rs.randn(16, 4).astype(np.float32)
    x = rs.randn(64, 16).astype(np.float32)
    inp = tmp / "in.npz"
    np.savez(inp, x=x, y=(x @ w_true).astype(np.float32), steps=np.int32(20))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-c", REF_SHARDED, str(inp), str(tmp / "ref.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen([sys.executable, str(HERE / "torch_train_world.py"), str(inp),
                                  str(tmp / "port.npz")],
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    for name, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"{name}: {err[-3000:]}"
    return dict(np.load(tmp / "ref.npz")), dict(np.load(tmp / "port.npz"))


@pytest.mark.parametrize("tag", ["comp", "full"])
def test_sharded_step_matches_the_reference_mesh(sharded, tag):
    ref, port = sharded
    np.testing.assert_allclose(port[tag + "_w"], ref[tag + "_w"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port[tag + "_loss"], ref[tag + "_loss"], rtol=1e-6)
    # rank 0's residual is pod 0's row of the reference's (n_pods, ...) leaf
    np.testing.assert_allclose(port[tag + "_err0"], ref[tag + "_err"][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port[tag + "_err2"], ref[tag + "_err"][1], rtol=1e-5, atol=1e-6)


def test_sharded_step_is_replicated_and_tracks_one_rank(sharded):
    """Every rank ends with rank 0's parameters (checked in the world);
    uncompressed, the 4 ranks equal one process on the whole batch within
    fp32 tolerance; compressed tracks uncompressed within the reference's
    own bound, max |Δw| < 0.05 (``tests/test_distributed.py``)."""
    _, port = sharded
    assert port["replicated"]
    np.testing.assert_allclose(port["full_w"], port["single_w"], rtol=1e-5, atol=1e-6)
    assert float(np.abs(port["comp_w"] - port["full_w"]).max()) < 0.05
