"""Port optimizers (``repro_torch.train.optimizer``) and the optimizer-state
carry of ``convert`` against the JAX package's, on the same numpy
parameters and gradients.

AdamW, Adafactor and SGD, one update and five chained updates, with and
without global-norm clipping: parameters and state within rtol 1e-6, atol
1e-7 of the reference's ``apply_updates`` run op by op, the order its source
gives (the two packages sum the global norm's and Adafactor's means in
different orders; under ``jit`` XLA also contracts ``p - lr * g`` into one
fused multiply-add, which the train-step tests meet at their looser
tolerance).  The tree mixes a
factorable matrix (≥ 128×128), a stacked one, small matrices, vectors and a
nested dict, so every branch of Adafactor runs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.train import optimizer as topt

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"big": (128, 160), "stack": (2, 128, 128), "w": (16, 8), "b": (8,),
          "mlp": {"w0": (8, 4), "b0": (4,)}}


def tree_np(shapes, seed, scale=1.0):
    rs = np.random.RandomState(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in sorted(node.items())}
        return (scale * rs.randn(*node)).astype(np.float32)

    return make(shapes)


def to_torch(tree):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def np_tree(tree):
    return jax.tree.map(lambda t: t.numpy() if torch.is_tensor(t) else np.asarray(t), tree)


def assert_trees_close(got, want, rtol=RTOL, atol=ATOL):
    got = np_tree(got)
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, want))[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert g.shape == w.shape, path
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=str(path))


def jax_apply(cfg):
    return functools.partial(jopt.apply_updates, cfg=cfg)


CONFIGS = [
    jopt.OptConfig(name="adamw", lr=0.05, weight_decay=0.01, grad_clip=1.0),
    jopt.OptConfig(name="adamw", lr=3e-3, b2=0.999, grad_clip=0.0),
    jopt.OptConfig(name="adafactor", lr=0.05, weight_decay=0.01, grad_clip=1.0),
    jopt.OptConfig(name="adafactor", lr=0.01, weight_decay=0.0, grad_clip=0.0),
    jopt.OptConfig(name="sgd", lr=0.1, grad_clip=1.0),
    jopt.OptConfig(name="sgd", lr=0.1, grad_clip=0.0),
]


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("jcfg", CONFIGS, ids=lambda c: f"{c.name}-clip{c.grad_clip}")
def test_updates_match_the_reference(jcfg, steps):
    tcfg = topt.OptConfig(**jcfg.__dict__)
    p_np = tree_np(SHAPES, 0)
    pj, pt = to_jax(p_np), to_torch(p_np)
    sj, st = jopt.init_opt_state(pj, jcfg), topt.init_opt_state(pt, tcfg)
    assert_trees_close(st, sj)
    for i in range(steps):
        g_np = tree_np(SHAPES, 10 + i, scale=0.3 + i)
        pj, sj, nj = jax_apply(jcfg)(pj, to_jax(g_np), sj)
        pt, st, nt = topt.apply_updates(pt, to_torch(g_np), st, tcfg)
        np.testing.assert_allclose(float(nt), float(nj), rtol=RTOL)
        assert_trees_close(pt, pj)
        assert_trees_close(st, sj)
        assert int(st["step"]) == int(sj["step"]) == i + 1
        assert st["step"].dtype == torch.int32


def test_clip_by_global_norm_matches_the_reference():
    g_np = tree_np(SHAPES, 3, scale=5.0)
    for max_norm in (1.0, 1e6):
        cj, nj = jopt.clip_by_global_norm(to_jax(g_np), max_norm)
        ct, nt = topt.clip_by_global_norm(to_torch(g_np), max_norm)
        np.testing.assert_allclose(float(nt), float(nj), rtol=RTOL)
        assert_trees_close(ct, cj)
    g = {"w": torch.full((4,), 100.0)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["w"])) == pytest.approx(1.0, rel=1e-4)


def test_global_norm_sums_leaves_in_sorted_key_order():
    tree = {"z": torch.ones(2), "a": {"y": torch.ones(3), "b": torch.ones(1)}}
    assert [t.numel() for t in topt.tree_leaves(tree)] == [1, 3, 2]
    assert [x.size for x in jax.tree_util.tree_leaves(np_tree(tree))] == [1, 3, 2]


def test_adafactor_state_is_factored():
    params = {"big": torch.zeros(256, 512), "small": torch.zeros(16),
              "stack": torch.zeros(3, 128, 200), "thin": torch.zeros(127, 512)}
    st = topt.init_opt_state(params, topt.OptConfig(name="adafactor"))
    assert st["vr"]["big"].shape == (256,) and st["vc"]["big"].shape == (512,)
    assert st["vr"]["stack"].shape == (3, 128) and st["vc"]["stack"].shape == (3, 200)
    assert st["vr"]["small"].shape == (1,) and st["vc"]["small"].shape == (16,)
    assert st["vr"]["thin"].shape == (1,) and st["vc"]["thin"].shape == (127, 512)
    ref = jopt.init_opt_state(jax.tree.map(lambda t: jnp.zeros(tuple(t.shape)), {
        k: v for k, v in params.items()}), jopt.OptConfig(name="adafactor"))
    assert_trees_close(st, ref)


def test_adamw_matches_manual_step():
    """One AdamW update against the textbook formula (the reference's own
    check, ``tests/test_train.py``)."""
    p = {"w": torch.tensor([[1.0, -2.0]])}
    g = {"w": torch.tensor([[0.5, 0.25]])}
    cfg = topt.OptConfig(name="adamw", lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01,
                         grad_clip=0.0)
    p2, _, _ = topt.apply_updates(p, g, topt.init_opt_state(p, cfg), cfg)
    m, v = 0.1 * g["w"].numpy(), 0.01 * g["w"].numpy() ** 2
    want = p["w"].numpy() - 0.1 * (m / 0.1 / (np.sqrt(v / 0.01) + 1e-8) + 0.01 * p["w"].numpy())
    np.testing.assert_allclose(p2["w"].numpy(), want, rtol=1e-5)


def test_updates_leave_their_inputs_untouched():
    p_np = tree_np(SHAPES, 0)
    pt = to_torch(p_np)
    cfg = topt.OptConfig(name="adamw", lr=0.1)
    st = topt.init_opt_state(pt, cfg)
    topt.apply_updates(pt, to_torch(tree_np(SHAPES, 1)), st, cfg)
    assert_trees_close(pt, p_np, rtol=0, atol=0)
    assert int(st["step"]) == 0 and float(st["m"]["big"].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_opt_state_carries_both_ways(name):
    jcfg = jopt.OptConfig(name=name, lr=0.05)
    pj = to_jax(tree_np(SHAPES, 0))
    _, sj, _ = jax_apply(jcfg)(pj, to_jax(tree_np(SHAPES, 1)), jopt.init_opt_state(pj, jcfg))
    st = convert.opt_state_from_numpy(jax.tree.map(np.asarray, sj))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 1
    back = convert.opt_state_to_numpy(st)
    assert_trees_close(back, sj, rtol=0, atol=0)
    assert back["step"].dtype == np.int32
    with pytest.raises(ValueError, match="optimizer state keys"):
        convert.opt_state_from_numpy({"m": {}, "step": 0})
