"""The port's training launcher (``repro_torch.launch.train``) on the CPU.

* deepfm and mace train for a few steps (``--device cpu``) with finite
  metrics; ``--accum-steps`` splits the batch.
* A run cut by ``--ckpt-every`` and continued with ``--resume`` ends bit for
  bit where an uninterrupted run ends: batches are a pure function of the
  step, and the checkpoint carries parameters and optimizer state whole.
* Checkpoints cross packages: one written by ``repro.launch.train``
  restores here (every leaf bit for bit, training resumes from its step),
  and one written here restores in ``repro.train.checkpoint``.
* gemma3-1b's smoke config trains for 2 steps with finite metrics; without
  a card the launcher raises unless given ``--device cpu``.
* A bf16 parameter (the full LM configs store bf16) goes through a
  checkpoint bit for bit.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import recsys as jrec
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro_torch.launch import train as ttrain
from repro_torch.train import checkpoint as tckpt

torch.set_num_threads(2)


def run(*args):
    return ttrain.main(["--device", "cpu", "--log-every", "1", *map(str, args)])


def flat_np(tree):
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in ttrain.flatten(tree).items()}


@pytest.mark.parametrize("arch,accum", [("deepfm", 1), ("mace", 1), ("xdeepfm", 2)])
def test_trains_on_cpu(arch, accum, capsys):
    rec = run("--arch", arch, "--steps", 4, "--accum-steps", accum)
    out = capsys.readouterr().out
    assert f"training {arch}" in out and "on cpu" in out and "trained 4 steps" in out
    assert out.count("step ") == 4 and "grad_norm=" in out
    assert all(np.isfinite(float(v)) for v in rec["metrics"].values())
    assert int(rec["opt_state"]["step"]) == 4


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    whole = run("--arch", "deepfm", "--steps", 6, "--ckpt", tmp_path / "a", "--ckpt-every", 6)
    run("--arch", "deepfm", "--steps", 3, "--ckpt", tmp_path / "b", "--ckpt-every", 3)
    assert tckpt.load_manifest(str(tmp_path / "b"))["step"] == 3
    resumed = run("--arch", "deepfm", "--steps", 6, "--ckpt", tmp_path / "b", "--ckpt-every", 3,
                  "--resume")
    assert resumed["start"] == 3
    a, b = flat_np({"0": whole["params"], "1": whole["opt_state"]}), \
        flat_np({"0": resumed["params"], "1": resumed["opt_state"]})
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert float(whole["metrics"]["loss"]) == float(resumed["metrics"]["loss"])


def test_reference_checkpoint_restores_in_the_port(tmp_path, monkeypatch):
    """``repro.launch.train`` writes (params, opt_state) after 2 steps; the
    port resumes from it: its leaves are the reference's, bit for bit."""
    from repro.launch import train as jtrain

    path = str(tmp_path / "ref")
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "deepfm", "--steps", "2", "--ckpt", path,
                                      "--ckpt-every", "2"])
    jtrain.main()
    rec = run("--arch", "deepfm", "--steps", 2, "--ckpt", path, "--resume")
    assert rec["start"] == 2 and int(rec["opt_state"]["step"]) == 2
    got = flat_np({"0": rec["params"], "1": rec["opt_state"]})
    manifest = tckpt.load_manifest(path)
    assert sorted(got) == sorted(r["name"] for r in manifest["leaves"])
    for r in manifest["leaves"]:
        want = np.load(tmp_path / "ref" / "shard-0" / r["file"])
        assert np.array_equal(got[r["name"]], want), r["name"]
    # and it trains on from there
    on = run("--arch", "deepfm", "--steps", 3, "--ckpt", path, "--resume")
    assert on["start"] == 2 and int(on["opt_state"]["step"]) == 3


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    run("--arch", "deepfm", "--steps", 2, "--ckpt", tmp_path / "port", "--ckpt-every", 2)
    from repro import configs as jconfigs

    cfg = jconfigs.get("deepfm").smoke_config()
    params = jrec.init_params(jax.random.PRNGKey(0), cfg)
    ocfg = jopt.OptConfig(name="adamw")
    like = (params, jopt.init_opt_state(params, ocfg))
    (p, st), step = jckpt.restore(str(tmp_path / "port"), like)
    assert step == 2 and int(st["step"]) == 2
    table = torch.zeros(tuple(params["table"].shape))
    mine, _ = tckpt.restore(str(tmp_path / "port"), ttrain.flatten({"0": {"table": table}}),
                            device="cpu")
    assert np.array_equal(np.asarray(p["table"]), mine["0/table"].numpy())


def test_lm_arch_trains_on_cpu(capsys):
    rec = run("--arch", "gemma3-1b", "--steps", 2, "--batch", 4, "--seq", 48)
    out = capsys.readouterr().out
    assert "training gemma3-1b (lm) on cpu" in out and "trained 2 steps" in out
    assert set(rec["metrics"]) == {"loss", "grad_norm", "xent"}
    assert all(np.isfinite(float(v)) for v in rec["metrics"].values())
    assert int(rec["opt_state"]["step"]) == 2 and rec["params"]["wq"].shape[0] == 3


def test_bf16_leaves_checkpoint_bit_for_bit(tmp_path):
    w = torch.randn(5, 7).bfloat16()
    tckpt.save(str(tmp_path), {"0/w": w, "1/step": 3}, step=3)
    back, step = tckpt.restore(str(tmp_path), {"0/w": torch.zeros(5, 7, dtype=torch.bfloat16),
                                               "1/step": 0}, device="cpu")
    assert step == 3 and back["1/step"] == 3
    assert back["0/w"].dtype == torch.bfloat16 and torch.equal(back["0/w"], w)


def test_launcher_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "deepfm", "--steps", "1"])


def test_lm_launcher_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "gemma3-1b", "--steps", "1"])


def test_flatten_names_are_the_references():
    tree = {"0": {"mlp": {"w0": 1, "b0": 2}, "table": 3}, "1": {"step": 4, "m": {"table": 5}}}
    flat = ttrain.flatten(tree)
    assert set(flat) == {"0/mlp/w0", "0/mlp/b0", "0/table", "1/step", "1/m/table"}
    assert ttrain.unflatten(flat) == tree
