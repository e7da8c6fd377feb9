"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy inputs and carried weights.

* ``apply_moe`` at groups 1 and 4, top-1 and top-2, ample and short
  capacity: outputs and the aux loss within rtol 1e-5 / atol 1e-6 of the
  reference's jitted function, the drop rate exactly equal.
* The dispatch buffers from ``segments.grouped_top_r``, recorded from both
  packages' eager calls: token ids and per-expert counts exactly equal,
  gates within rtol 1e-6 (softmax of fp32 logits summed in another order),
  on Gaussian tokens and on integer-valued ones whose router logits tie
  (equal router columns): the lower expert first, as ``lax.top_k`` orders
  ties.
* Identical tokens get identical outputs; tokens dropped at capacity get
  zero output.
* The scatter-add back: with at most two addends per token row (top-2), the
  order of the addends changes no bit.
* bf16 tokens against fp32 weights (the smoke configs' mix): within one
  bf16 rounding of the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import segments as jseg
from repro.models import moe as jmoe
from repro_torch.core import segments as tseg
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
T, D, F = 64, 16, 32


def params_of(cfg, seed=0, dtype=jnp.float32):
    pj = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, F, jmoe.MoEConfig(**cfg.__dict__),
                              dtype)
    pt = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in pj.items()}
    return pj, pt


def tcfg_of(**kw):
    return tmoe.MoEConfig(**kw)


def run_both(cfg, x, groups=1, capacity=None, pj_pt=None):
    pj, pt = pj_pt or params_of(cfg)
    jcfg = jmoe.MoEConfig(**cfg.__dict__)
    fn = jax.jit(lambda p, xx: jmoe.apply_moe(p, xx, jcfg, capacity=capacity, groups=groups))
    oj, aj = fn(pj, jnp.asarray(x))
    ot, at = tmoe.apply_moe(pt, torch.from_numpy(x), cfg, capacity=capacity, groups=groups)
    return (np.asarray(oj), {k: np.asarray(v) for k, v in aj.items()}), (ot, at)


@pytest.mark.parametrize("groups", (1, 4))
@pytest.mark.parametrize("top_k,cf", ((2, 1.25), (2, 0.25), (1, 8.0)))
def test_apply_moe_matches(groups, top_k, cf):
    cfg = tcfg_of(n_experts=4, top_k=top_k, capacity_factor=cf)
    x = np.random.RandomState(1).randn(T, D).astype(np.float32)
    (oj, aj), (ot, at) = run_both(cfg, x, groups=groups)
    np.testing.assert_allclose(ot.numpy(), oj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(at["moe_aux_loss"]), aj["moe_aux_loss"], rtol=RTOL)
    assert float(at["moe_drop_rate"]) == float(aj["moe_drop_rate"])
    if cf == 0.25:
        assert float(at["moe_drop_rate"]) > 0


@pytest.fixture
def recorded(monkeypatch):
    """Each package's grouped_top_r outputs, call by call."""
    seen = {"jax": [], "torch": []}
    jfn, tfn = jseg.grouped_top_r, tseg.grouped_top_r

    def jrec(*a, **kw):
        out = jfn(*a, **kw)
        seen["jax"].append(jax.tree.map(np.asarray, out))
        return out

    def trec(*a, **kw):
        out = tfn(*a, **kw)
        seen["torch"].append(out)
        return out

    monkeypatch.setattr(jseg, "grouped_top_r", jrec)
    monkeypatch.setattr(tseg, "grouped_top_r", trec)
    return seen


def tied_problem(seed):
    """Integer-valued tokens and a router whose columns come in equal pairs
    (and one all-zero column): router logits tie exactly."""
    rs = np.random.RandomState(seed)
    cfg = tcfg_of(n_experts=8, top_k=2, capacity_factor=0.5)
    pj, pt = params_of(cfg)
    cols = rs.randint(-2, 3, (D, 4)).astype(np.float32)
    router = np.concatenate([cols[:, :2], cols[:, :2], cols[:, 2:3], np.zeros((D, 1), np.float32),
                             cols[:, 3:4], cols[:, 3:4]], axis=1)
    pj = {**pj, "router": jnp.asarray(router)}
    pt = {**pt, "router": torch.from_numpy(router)}
    x = rs.randint(-2, 3, (T, D)).astype(np.float32)
    return cfg, x, (pj, pt)


@pytest.mark.parametrize("data", ("gauss", "tied"))
def test_dispatch_buffers_and_drops_equal(recorded, data):
    if data == "gauss":
        cfg = tcfg_of(n_experts=4, top_k=2, capacity_factor=0.5)
        x = np.random.RandomState(2).randn(T, D).astype(np.float32)
        pj_pt = params_of(cfg)
    else:
        cfg, x, pj_pt = tied_problem(3)
    jcfg = jmoe.MoEConfig(**cfg.__dict__)
    oj, aj = jmoe.apply_moe(pj_pt[0], jnp.asarray(x), jcfg)  # eager: buffers recorded
    ot, at = tmoe.apply_moe(pj_pt[1], torch.from_numpy(x), cfg)
    ((jtok, jgate), jcounts), = recorded["jax"]
    ((ttok, tgate), tcounts), = recorded["torch"]
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    np.testing.assert_allclose(tgate.numpy(), jgate, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tcounts.numpy(), jcounts)
    assert float(at["moe_drop_rate"]) == float(aj["moe_drop_rate"]) > 0
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)


def test_ties_take_the_lower_expert():
    """Equal router columns 0/2, 1/3 and 6/7: where the two experts a token
    keeps tie, the lower comes first, and where only one of a tied pair is
    kept, it is the lower; the choice equals ``lax.top_k``'s."""
    cfg, x, (_, pt) = tied_problem(5)
    probs = torch.softmax(torch.from_numpy(x) @ pt["router"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids = top.indices[:, :2]
    jids = np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1])
    np.testing.assert_array_equal(ids.numpy(), jids)
    tied = top.values[:, 0] == top.values[:, 1]
    assert bool(tied.any()) and bool((ids[tied, 0] < ids[tied, 1]).all())
    for lo, hi in ((0, 2), (1, 3), (6, 7)):
        assert bool((probs[:, lo] == probs[:, hi]).all())
        only_one = (ids == lo).any(dim=1) ^ (ids == hi).any(dim=1)
        assert not bool((ids[only_one] == hi).any())


def test_identical_tokens_identical_outputs_and_drops_are_zero():
    cfg = tcfg_of(n_experts=4, top_k=1, capacity_factor=8.0)
    _, pt = params_of(cfg)
    x = torch.from_numpy(np.tile(np.random.RandomState(4).randn(1, D).astype(np.float32), (8, 1)))
    out, aux = tmoe.apply_moe(pt, x, cfg)
    assert torch.equal(out, out[:1].expand_as(out)) and float(aux["moe_drop_rate"]) == 0.0
    # capacity 8 of 32 identical top-1 tokens: the 24 after the first 8 drop
    x32 = x[:1].expand(32, D).contiguous()
    out, aux = tmoe.apply_moe(pt, x32, cfg, capacity=8)
    assert float(aux["moe_drop_rate"]) == 24 / 32
    assert bool((out[8:] == 0).all()) and bool((out[:8] != 0).any())


def test_scatter_add_order_changes_no_bit():
    """Each token row takes two addends (its two experts) into zero: added
    in either order, the sums are the same bits."""
    rs = np.random.RandomState(6)
    idx = torch.from_numpy(np.concatenate([rs.permutation(T), rs.permutation(T)]))
    src = torch.from_numpy(rs.randn(2 * T, D).astype(np.float32))
    zero = torch.zeros(T, D)
    a = zero.index_add(0, idx, src)
    b = zero.index_add(0, idx.flip(0), src.flip(0))
    assert torch.equal(a, b)
    a16 = zero.bfloat16().index_add(0, idx, src.bfloat16())
    assert torch.equal(a16, zero.bfloat16().index_add(0, idx.flip(0), src.bfloat16().flip(0)))


@pytest.mark.parametrize("groups", (1, 4))
def test_bf16_tokens_against_fp32_weights(groups):
    cfg = tcfg_of(n_experts=4, top_k=2)
    x = np.random.RandomState(7).randn(T, D).astype(np.float32)
    pj, pt = params_of(cfg)
    jcfg = jmoe.MoEConfig(**cfg.__dict__)
    oj, aj = jax.jit(lambda p, xx: jmoe.apply_moe(p, xx, jcfg, groups=groups))(
        pj, jnp.asarray(x, jnp.bfloat16))
    ot, at = tmoe.apply_moe(pt, torch.from_numpy(x).bfloat16(), cfg, groups=groups)
    assert ot.dtype == torch.bfloat16
    want = np.asarray(oj, np.float32)
    np.testing.assert_allclose(ot.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())
    assert float(at["moe_drop_rate"]) == float(aj["moe_drop_rate"])
