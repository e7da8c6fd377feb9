"""Training the port's LMs (``repro_torch.models.transformer``) against the
reference, and the example ``examples/train_lm_torch.py``.

* One AdamW step of gemma3's smoke config (fp32 compute) against the
  reference's jitted train step: loss, grad_norm and xent within rtol 1e-5,
  each gradient leaf within 1e-4 of its largest element against
  ``jax.grad``, and the update on the reference's own gradients within
  rtol 1e-6 (``tests/test_torch_train_loop.py``'s tolerances: AdamW's
  m/sqrt(v) turns a gradient that cancels to ~1e-8 into a unit step, so its
  parameters are held on identical gradients only).
* ``remat=True`` (``torch.utils.checkpoint`` per layer) gives the same loss
  and gradients, bit for bit.
* The example at ``--tiny`` on the CPU: its loss falls, checkpoints land
  every 100 steps, and it raises without a card unless given
  ``--device cpu``.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.models import transformer as jtfm
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch.models import transformer as ttfm
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RTOL = tp.RTOL
B, S = 2, 40
problem, tokens_of = tp.lm_problem, tp.lm_tokens


def grads_of(pt, toks, cfg):
    (loss, metrics), grads = tloop.value_and_grad(
        lambda p, b: ttfm.loss_fn(p, b, cfg), pt, torch.from_numpy(toks))
    return loss, grads


@pytest.mark.parametrize("arch", ("gemma3-1b", "arctic-480b"))
def test_remat_gives_the_same_loss_and_grads(arch):
    _, tc, _, pt = problem(arch, "bfloat16")
    toks = tokens_of(tc.vocab, (B, S), seed=6)
    l0, g0 = grads_of(pt, toks, tc)
    l1, g1 = grads_of(pt, toks, dataclasses.replace(tc, remat=True))
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_adamw_step_against_the_reference():
    jc, tc, pj, pt = problem("gemma3-1b", "float32")
    toks = tokens_of(jc.vocab, (4, 32), seed=7)
    jcfg, tcfg = jopt.OptConfig(name="adamw", lr=1e-3), topt.OptConfig(name="adamw", lr=1e-3)
    jstate = jopt.init_opt_state(pj, jcfg)
    jstep = jax.jit(jloop.make_train_step(lambda p, b: jtfm.loss_fn(p, b["tokens"], jc), jcfg))
    pj1, _, mj = jstep(pj, jstate, {"tokens": toks})
    tstep = tloop.make_train_step(lambda p, b: ttfm.loss_fn(p, b["tokens"], tc), tcfg)
    pt1, tstate, mt = tstep(pt, topt.init_opt_state(pt, tcfg), {"tokens": torch.from_numpy(toks)})
    for k in ("loss", "grad_norm", "xent"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=RTOL)
    # gradients leaf by leaf, each within 1e-4 of its largest element
    _, gt = grads_of(pt, toks, tc)
    gj = jax.jit(jax.grad(lambda p: jtfm.loss_fn(p, toks, jc)[0]))(pj)
    for k in gt:
        want = np.asarray(gj[k])
        np.testing.assert_allclose(gt[k].numpy(), want, rtol=0,
                                   atol=1e-4 * max(np.abs(want).max(), 1e-30))
    # the update on the reference's own gradients
    gj_t = {k: torch.from_numpy(np.array(v)) for k, v in gj.items()}
    upd, _, _ = topt.apply_updates(pt, gj_t, topt.init_opt_state(pt, tcfg), tcfg)
    want, _, _ = jopt.apply_updates(pj, gj, jopt.init_opt_state(pj, jcfg), jcfg)  # op by op
    for k in upd:
        np.testing.assert_allclose(upd[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    assert int(tstate["step"]) == 1 and set(pt1) == set(pj1)


def example():
    spec = importlib.util.spec_from_file_location("train_lm_torch",
                                                  ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_and_checkpoints(tmp_path, capsys):
    out = example().main(["--tiny", "--steps", "101", "--batch", "4", "--seq", "64",
                          "--device", "cpu", "--ckpt", str(tmp_path / "ck")])
    assert out["last"] < out["first"]
    assert "loss must decrease" not in capsys.readouterr().out
    assert tckpt.load_manifest(str(tmp_path / "ck"))["step"] == 100


def test_example_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example().main(["--tiny", "--steps", "1"])
