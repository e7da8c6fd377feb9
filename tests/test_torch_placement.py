"""Placement on the production meshes (``models.sharding``, the four
``param_pspecs``, ``optimizer.opt_state_pspecs``,
``launch.mesh.make_production_mesh``) against the reference's.

Every spec leaf of every arch equals the reference's ``PartitionSpec`` as a
tuple.  Placed on the (16, 16) and (2, 16, 16) meshes of a fake world, under
``FakeTensorMode`` (nothing allocated), every parameter and optimizer-state
leaf's local shape on rank 0 equals the reference's
``NamedSharding(AbstractMesh(...), spec).shard_shape``.  JAX refuses a split
that does not divide a dimension; DTensor splits it as ``torch.chunk``
does, the first ranks taking the ceiling, and those leaves are held to
that instead (none of the full configs has one; the case is checked on a
small tensor).  ``constrain`` is the identity on plain tensors and off a
mesh, and a smoke LM forward through every constrain site reads the same
bits with a mesh set as without one.  The constrain sites themselves: each
LM's smoke forward, prefill and both decode steps make the same
``constrain`` calls (tensor shape and spec) as the reference's, and each
call's spec, sent with a DTensor of its shape through ``constrain`` on both
production meshes, gives that spec's placements.

The fake process group is global to the process, so each test that makes
one leaves it in a ``finally`` (other files run in the same worker).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

import torch_parity as tp
from repro.configs import get as jget
from repro.models import mace as jmace
from repro.models import recsys as jrec
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import placement
from repro_torch.models import moe, sharding, transformer
from repro_torch.train import optimizer

torch.set_num_threads(2)

ARCHS = placement.ARCHS
MESHES = [False, True]  # multi_pod


@contextlib.contextmanager
def production_mesh(multi_pod: bool):
    """The production mesh over a fake world, left (mesh unset, group
    destroyed) on exit."""
    shape, _ = mesh_lib.PRODUCTION_MESHES[multi_pod]
    mesh_lib.fake_world(int(np.prod(shape)))
    try:
        yield mesh_lib.make_production_mesh(multi_pod=multi_pod)
    finally:
        sharding.set_mesh(None)
        mesh_lib.close_group()


def _leaves(tree, path=()):
    """[(path, leaf)] with dict keys sorted; spec tuples are leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _reference(arch):
    """(param specs, param shapes, optimizer config) the reference's dry
    run plans ``arch`` with (``repro.configs.cells``)."""
    mod = jget(arch)
    cfg = mod.full_config()
    if mod.FAMILY == "lm":
        shapes = jax.eval_shape(lambda k: jtfm.init_params(k, cfg), jax.random.PRNGKey(0))
        specs = jtfm.param_pspecs(cfg, fsdp=True)
        name = "adafactor" if cfg.param_count() > 1e11 else "adamw"
    elif arch == "mace":
        shapes = jax.eval_shape(lambda k: jmace.init_params(k, cfg), jax.random.PRNGKey(0))
        specs, name = jmace.param_pspecs(cfg), "adamw"
    else:
        shapes = jax.eval_shape(lambda k: jrec.init_params(k, cfg), jax.random.PRNGKey(0))
        specs, name = jrec.param_pspecs(cfg), "adamw"
    return specs, shapes, jopt.OptConfig(name=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_pspecs_match_reference_leaf_by_leaf(arch):
    """``param_pspecs`` (LMs with and without FSDP) and, for each optimizer,
    ``opt_state_pspecs`` equal the reference's leaf by leaf."""
    jspecs, jshapes, jocfg = _reference(arch)
    mod = configs.get(arch)
    cfg = mod.full_config()
    if mod.FAMILY == "lm":
        for fsdp in (False, True):
            got = _leaves(transformer.param_pspecs(cfg, fsdp=fsdp))
            want = _leaves(jtfm.param_pspecs(jget(arch).full_config(), fsdp=fsdp))
            assert [(p, tuple(s)) for p, s in want] == got, fsdp
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params, specs, ocfg = placement.arch_tree(arch)
    assert ocfg.name == jocfg.name
    assert [(p, tuple(s)) for p, s in _leaves(jspecs)] == _leaves(specs)
    assert [(p, tuple(s.shape)) for p, s in _leaves(jshapes)] == [
        (p, tuple(t.shape)) for p, t in _leaves(params)]
    for name in ("adamw", "adafactor", "sgd"):
        want = jopt.opt_state_pspecs(jspecs, jshapes, jopt.OptConfig(name=name))
        got = optimizer.opt_state_pspecs(specs, params, optimizer.OptConfig(name=name))
        want = [(p, tuple(s)) for p, s in jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, P))]
        want = [(tuple(k.key for k in p), s) for p, s in want]
        assert sorted(want) == sorted(_leaves(got)), name


def _shard_shape(mesh_shape, names, spec, shape):
    return NamedSharding(AbstractMesh(mesh_shape, names), P(*spec)).shard_shape(tuple(shape))


@pytest.mark.parametrize("multi_pod", MESHES, ids=["16x16", "2x16x16"])
def test_local_shapes_match_reference_shard_shape(multi_pod):
    """Every arch's parameters and optimizer state, placed: rank 0's block
    of every leaf has the reference's shard shape."""
    mesh_shape, names = mesh_lib.PRODUCTION_MESHES[multi_pod]
    with production_mesh(multi_pod) as mesh:
        assert tuple(mesh.shape) == mesh_shape and tuple(mesh.mesh_dim_names) == names
        for arch in ARCHS:
            params, specs, state, state_specs = placement.place_arch(arch, mesh)
            for tree, spec_tree in ((params, specs), (state, state_specs)):
                placed = _leaves(tree)
                assert [p for p, _ in placed] == [p for p, _ in _leaves(spec_tree)]
                for (path, t), (_, spec) in zip(placed, _leaves(spec_tree)):
                    assert isinstance(t, DTensor), (arch, path)
                    want = _shard_shape(mesh_shape, names, spec, t.shape)
                    assert tuple(t.to_local().shape) == want, (arch, path, spec)


def test_uneven_split_takes_torch_chunk_blocks():
    """Where JAX refuses a split that does not divide the dimension, rank 0
    holds the ceiling, as ``torch.chunk`` splits."""
    with production_mesh(False) as mesh:
        t = distribute_tensor(torch.zeros(30, 4), mesh,
                              sharding.placements(mesh, ("model", None)), src_data_rank=None)
        assert tuple(t.to_local().shape) == (2, 4)
        with pytest.raises(ValueError):
            _shard_shape((16, 16), ("data", "model"), ("model", None), (30, 4))


def test_placements_and_batch_axes():
    with production_mesh(True) as mesh:
        assert sharding.batch_axes(mesh) == ("pod", "data")
        assert sharding.placements(mesh, ("batch", None, "model")) == [
            Shard(0), Shard(0), Shard(2)]
        assert sharding.placements(mesh, (("pod", "data"), None)) == [
            Shard(0), Shard(0), Replicate()]
        assert sharding.placements(mesh, sharding.named(None, "model")) == [
            Replicate(), Replicate(), Shard(1)]
        with pytest.raises(ValueError, match="mesh order"):
            sharding.placements(mesh, (("data", "pod"),))
        with pytest.raises(ValueError, match="twice"):
            sharding.placements(mesh, ("model", "model"))
        # "batch" resolves to (pod, data): the dimension splits 2 x 16 ways
        t = distribute_tensor(torch.zeros(64, 4), mesh,
                              sharding.placements(mesh, ("batch", None)), src_data_rank=None)
        assert tuple(t.to_local().shape) == _shard_shape(
            (2, 16, 16), ("pod", "data", "model"), (("pod", "data"), None), (64, 4))
    with production_mesh(False) as mesh:
        assert sharding.batch_axes(mesh) == ("data",)
    assert sharding.batch_axes() == ("data",)
    with pytest.raises(ValueError, match="world of 256"):
        mesh_lib.make_production_mesh()


def test_constrain_identity_off_mesh_and_on_plain_tensors():
    x = torch.arange(12.0).reshape(3, 4)
    assert sharding.get_mesh() is None
    assert sharding.constrain(x, "batch", "model") is x
    with production_mesh(False) as mesh:
        sharding.set_mesh(mesh)
        assert sharding.constrain(x, "batch", "model") is x
        d = distribute_tensor(torch.zeros(32, 32), mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        out = sharding.constrain(d, "batch", "model")
        assert out.placements == (Shard(0), Shard(1))
        assert tuple(out.to_local().shape) == (2, 2)
    assert sharding.get_mesh() is None


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "gemma3-1b"])
def test_lm_forward_same_bits_with_a_mesh_set(arch):
    """The smoke forward through every constrain site (the unrolled
    schedule with ZeRO-3 use constraints, sequence sharding and grouped MoE
    dispatch) on plain tensors: the same bits with the production mesh set
    as without it."""
    cfg = dataclasses.replace(configs.get(arch).smoke_config(), unrolled=True,
                              zero3_use_constraints=True, seq_shard=True, moe_groups=2,
                              remat=False, param_dtype="float32", compute_dtype="float32")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.from_numpy(tp.lm_tokens(cfg.vocab, (2, 16)))
    want, _ = transformer.forward(params, tokens, cfg)
    logits_w, cache_w = transformer.prefill(params, tokens, cfg)
    with production_mesh(False) as mesh:
        sharding.set_mesh(mesh)
        got, _ = transformer.forward(params, tokens, cfg)
        logits_g, cache_g = transformer.prefill(params, tokens, cfg)
    assert torch.equal(got, want)
    assert torch.equal(logits_g, logits_w) and torch.equal(cache_g["k"], cache_w["k"])


LM_ARCHS = [a for a in ARCHS if configs.get(a).FAMILY == "lm"]


def _site_config(mod):
    """The smoke config with every constrain site switched on: the unrolled
    schedule, ZeRO-3 use constraints, sequence sharding, grouped MoE."""
    return dataclasses.replace(mod.smoke_config(), unrolled=True, zero3_use_constraints=True,
                               seq_shard=True, moe_groups=2, remat=False,
                               param_dtype="float32", compute_dtype="float32")


def _recorder(monkeypatch, modules):
    """Replace ``constrain`` in ``modules`` by a recorder of (shape, spec)
    that returns its input."""
    calls = []

    def record(x, *spec):
        calls.append((tuple(x.shape), tuple(spec)))
        return x

    for m in modules:
        monkeypatch.setattr(m, "constrain", record)
    return calls


def _sorted(calls):
    return sorted(calls, key=repr)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_constrain_sites_match_reference(arch, monkeypatch):
    """forward, prefill, decode_step and decode_step_split at the smoke size
    call ``constrain`` with the reference's shapes and specs, as many times;
    then every spec seen, on a DTensor of its shape, is redistributed by
    ``constrain`` to ``placements(mesh, spec)`` on both production meshes."""
    import repro.models.sharding as jsharding

    B, S, max_seq = 2, 16, 24
    tokens = tp.lm_tokens(configs.get(arch).smoke_config().vocab, (B, S))
    step = tokens[:, 0].astype(np.int32)

    jcfg = _site_config(jget(arch))
    jparams = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg), jax.random.PRNGKey(0))
    jcalls = _recorder(monkeypatch, [jtfm, jsharding])  # moe imports it from sharding
    want = {}
    for path, fn in (
            ("forward", lambda p: jtfm.forward(p, jnp.asarray(tokens), jcfg)),
            ("prefill", lambda p: jtfm.prefill(p, jnp.asarray(tokens), jcfg)),
            ("decode_step", lambda p: jtfm.decode_step(
                p, jtfm.init_cache(jcfg, B, max_seq), jnp.asarray(step), jcfg)),
            ("decode_step_split", lambda p: jtfm.decode_step_split(
                p, jtfm.init_split_cache(jcfg, B, max_seq), jnp.asarray(step), jcfg))):
        jcalls.clear()
        jax.eval_shape(fn, jparams)
        want[path] = _sorted(jcalls)
    assert want["forward"]

    cfg = _site_config(configs.get(arch))
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    tt, ts = torch.from_numpy(tokens), torch.from_numpy(step)
    calls = _recorder(monkeypatch, [transformer, moe])
    got = {}
    for path, fn in (
            ("forward", lambda: transformer.forward(params, tt, cfg)),
            ("prefill", lambda: transformer.prefill(params, tt, cfg)),
            ("decode_step", lambda: transformer.decode_step(
                params, transformer.init_cache(cfg, B, max_seq, device="cpu"), ts, cfg)),
            ("decode_step_split", lambda: transformer.decode_step_split(
                params, transformer.init_split_cache(cfg, B, max_seq, device="cpu"), ts,
                cfg))):
        calls.clear()
        with torch.no_grad():
            fn()
        got[path] = _sorted(calls)
    assert got == want
    monkeypatch.undo()

    seen = sorted({c for path in got.values() for c in path}, key=repr)
    for multi_pod in MESHES:
        with production_mesh(multi_pod) as mesh:
            sharding.set_mesh(mesh)
            for shape, spec in seen:
                assert len(spec) == len(shape), (shape, spec)
                d = distribute_tensor(torch.zeros(shape), mesh,
                                      [Replicate()] * mesh.ndim, src_data_rank=None)
                out = sharding.constrain(d, *spec)
                assert list(out.placements) == sharding.placements(mesh, spec), (shape, spec)
                assert tuple(out.shape) == shape
