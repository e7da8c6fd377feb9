"""The port's decoder LM (``repro_torch.models.transformer``) against
``repro.models.transformer`` on the reference's parameters, carried with
``convert.lm_params_from_numpy``, and the same numpy tokens.

For each of the five LM archs' ``smoke_config()``, at two tiers:

* tight: ``compute_dtype="float32"`` (as ``tests/test_models.py`` does),
  within rtol 1e-5 and an atol of 1e-6 times the largest element of the
  reference's jitted functions' outputs (a logit or K/V element is a sum of
  d products; one near zero keeps the absolute rounding of those terms,
  2.6e-6 measured beside logits of 13, so its bound scales with the row,
  not with itself):
  ``forward`` logits, ``loss_fn`` and its metrics, ``prefill`` logits.
  Prefill's K/V cache is bf16, so it is held to one bf16 rounding (rtol
  2^-7: a value on a rounding boundary may round either way) on top of the
  tight bound; the MoE drop rate exactly (``tests/test_torch_decode.py``
  holds the decode steps the same way);
* loose: the configs as they are (bf16 compute over fp32 parameters).  XLA
  and torch round bf16 products differently, and 2-3 layers compound it;
  measured on these inputs the logits differ by at most 0.66% of the
  largest logit (forward; prefill 0.35%, the caches 0.67%), so they are
  held within 2^-6 (1.56%) of it.

Also: the unrolled (tiled) schedule equals the scanned (chunked) one, both
packages; every ``full_config()``'s ``param_count``, ``active_param_count``,
``window_by_layer`` and parameter shapes equal the reference's; the
parameter carry round-trips bit for bit, bf16 leaves included.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro import configs as jconfigs
from repro.models import transformer as jtfm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import transformer as ttfm

torch.set_num_threads(2)

ARCHS, TIERS, RTOL, ATOL = tp.LM_ARCHS, tp.LM_TIERS, tp.RTOL, tp.ATOL
B, S = 2, 40
problem, tokens_of, close, bf16_close = tp.lm_problem, tp.lm_tokens, tp.lm_close, tp.bf16_close


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_prefill(arch, tier):
    jc, tc, pj, pt = problem(arch, tier)
    toks = tokens_of(jc.vocab, (B, S))
    lj, aj = jax.jit(lambda p, t: jtfm.forward(p, t, jc))(pj, toks)
    lt, at = ttfm.forward(pt, torch.from_numpy(toks), tc)
    assert lt.dtype == getattr(torch, tc.compute_dtype) and lt.shape == (B, S, tc.vocab)
    close(lt, lj, tier)
    assert set(at) == set(aj)
    for k in at:  # the MoE aux loss and drop rate per layer (bf16: 2.7e-3 measured)
        np.testing.assert_allclose(at[k].numpy(), np.asarray(aj[k]),
                                   rtol=RTOL if tier == "float32" else 1e-2)

    (loss_j, mj) = jax.jit(lambda p, t: jtfm.loss_fn(p, t, jc))(pj, toks)
    loss_t, mt = ttfm.loss_fn(pt, torch.from_numpy(toks), tc)
    rtol = RTOL if tier == "float32" else 1e-3  # bf16: at most 9e-5 measured
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=rtol)
    assert set(mt) == set(mj)
    np.testing.assert_allclose(float(mt["xent"]), float(mj["xent"]), rtol=rtol)
    if "moe_drop_rate" in mt:
        assert float(mt["moe_drop_rate"]) == float(mj["moe_drop_rate"])

    pl_j, cj = jax.jit(lambda p, t: jtfm.prefill(p, t, jc))(pj, toks)
    pl_t, ct = ttfm.prefill(pt, torch.from_numpy(toks), tc)
    assert pl_t.dtype == torch.float32 and ct["k"].dtype == torch.bfloat16
    close(pl_t, pl_j, tier)
    assert ct["k"].shape == cj["k"].shape and torch.equal(ct["len"], torch.full((B,), S,
                                                                                dtype=torch.int32))
    if tier == "float32":
        bf16_close(ct["k"], cj["k"])
        bf16_close(ct["v"], cj["v"])
    else:
        close(ct["k"], cj["k"], tier)
        close(ct["v"], cj["v"], tier)


@pytest.mark.parametrize("arch", ("gemma3-1b", "mixtral-8x7b"))
def test_unrolled_equals_scan(arch):
    jc, tc, pj, pt = problem(arch, "float32")
    toks = tokens_of(jc.vocab, (B, S), seed=5)
    scan = ttfm.forward(pt, torch.from_numpy(toks), tc)[0]
    unrolled = ttfm.forward(pt, torch.from_numpy(toks), dataclasses.replace(tc, unrolled=True))[0]
    np.testing.assert_allclose(unrolled.numpy(), scan.numpy(), rtol=RTOL, atol=ATOL)
    ju = dataclasses.replace(jc, unrolled=True)
    want = jax.jit(lambda p, t: jtfm.forward(p, t, ju))(pj, toks)[0]
    close(unrolled, want, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_counts_and_windows(arch):
    jc, tc = jconfigs.get(arch).full_config(), tconfigs.get(arch).full_config()
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    np.testing.assert_array_equal(tc.window_by_layer(), jc.window_by_layer())
    assert tc.head_dim == jc.head_dim and tc.remat and not tconfigs.get(arch).smoke_config().remat
    shapes = {k: s for k, (s, _) in ttfm.param_shapes(tc).items()}
    want = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0), jc))
    assert shapes == {k: tuple(v.shape) for k, v in want.items()}
    # param_count leaves out qwen's QKV biases, as the reference's does
    n = sum(int(np.prod(s)) for k, s in shapes.items() if k not in ("bq", "bk", "bv"))
    assert n == tc.param_count()


def test_param_carry_round_trips_bit_for_bit():
    jc = dataclasses.replace(jconfigs.get("arctic-480b").smoke_config(), param_dtype="bfloat16")
    tc = dataclasses.replace(tconfigs.get("arctic-480b").smoke_config(), param_dtype="bfloat16")
    pj = jtfm.init_params(jax.random.PRNGKey(2), jc)
    pt = convert.lm_params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, tc)
    assert pt["wq"].dtype == torch.bfloat16 and pt["router"].dtype == torch.float32
    back = convert.lm_params_to_numpy(pt)
    for k, v in pj.items():
        np.testing.assert_array_equal(back[k], np.asarray(v, np.float32))
    again = convert.lm_params_from_numpy(back, tc)
    for k in pt:
        assert torch.equal(again[k], pt[k]), k
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params_from_numpy({k: v for k, v in back.items() if k != "head"}, tc)
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params_from_numpy(back, dataclasses.replace(tc, d_model=32))
