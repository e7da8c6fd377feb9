"""The port's decode steps (``repro_torch.models.transformer.decode_step``
and ``decode_step_split``) against the reference's jitted ones, on the
reference's parameters carried across and the same numpy tokens.

For each of the five LM archs' ``smoke_config()``, from empty caches,
teacher-forced, past the ring's wrap (gemma3's 16-slot rings: 24 steps past
it, mixtral's 32: 24 past; the all-global archs 24 steps, where the split
cache is the dense one): the logits of every step and the caches after the
last, at the two tiers of ``tests/test_torch_transformer.py``: fp32
compute within rtol 1e-5 and 1e-6 of the largest element; the configs' own
bf16 within 2^-6 of the largest (measured at most 0.68%, gemma3's dense
decode, whose logits are softcapped in bf16).  The port writes the caches in place;
the reference returns new ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.models import transformer as jtfm
from repro_torch.models import transformer as ttfm

torch.set_num_threads(2)

ARCHS, TIERS, B = tp.LM_ARCHS, tp.LM_TIERS, 2
problem, tokens_of, close = tp.lm_problem, tp.lm_tokens, tp.lm_close


def decode_plan(tc):
    """(max_seq, steps): past the ring's wrap by 24 steps where a layer is
    windowed, else 24 steps."""
    wins = [int(w) for w in tc.window_by_layer() if int(w) < ttfm.FULL_WINDOW]
    if wins:
        w = max(wins)
        return w + 32, w + 24
    return 32, 24


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_dense_and_split(arch, tier):
    jc, tc, pj, pt = problem(arch, tier)
    max_seq, steps = decode_plan(tc)
    toks = tokens_of(jc.vocab, (B, steps), seed=3)
    cdt = jnp.float32 if tier == "float32" else jnp.bfloat16
    tdt = torch.float32 if tier == "float32" else torch.bfloat16
    jdense, jsplit = jtfm.init_cache(jc, B, max_seq, cdt), jtfm.init_split_cache(jc, B, max_seq, cdt)
    tdense = ttfm.init_cache(tc, B, max_seq, tdt, device="cpu")
    tsplit = ttfm.init_split_cache(tc, B, max_seq, tdt, device="cpu")
    assert {k: tuple(v.shape) for k, v in tsplit.items()} == \
        {k: tuple(v.shape) for k, v in jsplit.items()}
    step_d = jax.jit(lambda p, c, t: jtfm.decode_step(p, c, t, jc))
    step_s = jax.jit(lambda p, c, t: jtfm.decode_step_split(p, c, t, jc))
    for t in range(steps):
        ld_j, jdense = step_d(pj, jdense, toks[:, t])
        ls_j, jsplit = step_s(pj, jsplit, toks[:, t])
        tok = torch.from_numpy(toks[:, t])
        ld_t, tdense = ttfm.decode_step(pt, tdense, tok, tc)
        ls_t, tsplit = ttfm.decode_step_split(pt, tsplit, tok, tc)
        close(ld_t, ld_j, tier)
        close(ls_t, ls_j, tier)
    assert int(tsplit["len"][0]) == steps
    for tc_, jc_ in ((tdense, jdense), (tsplit, jsplit)):
        assert set(tc_) == set(jc_)
        assert torch.equal(tc_["len"], torch.from_numpy(np.asarray(jc_["len"])))
        for name in set(tc_) - {"len"}:
            close(tc_[name], jc_[name], tier)


def test_caches_are_written_in_place():
    _, tc, _, pt = problem("gemma3-1b", "float32")
    dense = ttfm.init_cache(tc, B, 24, device="cpu")
    split = ttfm.init_split_cache(tc, B, 24, device="cpu")
    tok = torch.zeros(B, dtype=torch.int32)
    _, d1 = ttfm.decode_step(pt, dense, tok, tc)
    _, s1 = ttfm.decode_step_split(pt, split, tok, tc)
    assert d1["k"] is dense["k"] and s1["k_loc"] is split["k_loc"] and s1["k_glob"] is split["k_glob"]
    assert bool((dense["k"][:, :, 0] != 0).any()) and int(d1["len"][0]) == 1
    assert int(split["len"][0]) == 0  # the input's len is not advanced
