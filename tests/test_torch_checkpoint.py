"""Build checkpoints (``train.checkpoint``), the build launcher's
checkpoint/resume/eval flags and the synthetic generators behind ``--kind``.

* A ``save_graph`` written by the reference restores in the port and one
  written by the port restores in the reference, bit for bit (the same
  on-disk layout).
* ``launch.build_graph --ckpt DIR --ckpt-every 2`` interrupted after a
  checkpoint and run again with ``--resume`` ends with the graph of an
  uninterrupted build, bit for bit; ``--eval`` prints recall@1 and recall@k.
* ``synthetic.make``'s generators give the reference's shapes and dtypes
  and each distribution's defining property; their numbers cannot equal the
  reference's (torch cannot replay ``jax.random``).
* ``build_parallel`` whose merge tree keeps no coarse level re-derives one
  with the reference's draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity as tp
from repro.core import construct as jconstruct
from repro.core import graph as jgraph
from repro.core import hierarchy as jhier
from repro.data import synthetic as jsynth
from repro.train import checkpoint as jckpt
from repro_torch import convert
from repro_torch.core import construct as tconstruct
from repro_torch.core import graph as tgraph
from repro_torch.data import synthetic as tsynth
from repro_torch.launch import build_graph
from repro_torch.train import checkpoint as tckpt

torch.set_num_threads(2)

K = 8
CFG = dict(k=K, wave=64, beam=16, n_seeds=4, max_iters=20)


@pytest.fixture(scope="module")
def built():
    """A reference build of 300 integer rows and the port's from the same
    replayed keys."""
    with tp.compiled_reference():
        return tp.build_both(tp.int_data(300, 8, seed=1), 2, **CFG)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_graph_checkpoint_across_packages(built, tmp_path, writer):
    (g_j, _), (g_t, _) = built
    path = str(tmp_path / "ck")
    cfg = dataclasses.asdict(tconstruct.BuildConfig(**CFG))
    if writer == "reference":
        jckpt.save_graph(path, g_j, 300, cfg)
        got, step = tckpt.restore_graph(path, tgraph.empty_graph(300, K), device="cpu")
        tp.assert_graphs_equal(got, g_j, "reference -> port")
        assert step == 300 and tckpt.load_manifest(path)["meta"]["kind"] == "knn_graph"
    else:
        tckpt.save_graph(path, g_t, 300, cfg)
        got, step = jckpt.restore_graph(path, jgraph.empty_graph(300, K))
        tp.assert_graphs_equal(g_t, got, "port -> reference")
        assert step == 300 and jckpt.load_manifest(path)["meta"]["build_cfg"]["k"] == K


def test_restore_refuses_a_mismatched_shape(built, tmp_path):
    (_, _), (g_t, _) = built
    path = str(tmp_path / "ck")
    tckpt.save_graph(path, g_t, 300, {})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_graph(path, tgraph.empty_graph(301, K), device="cpu")
    with pytest.raises(KeyError, match="extra"):
        tckpt.restore(path, {"extra": torch.zeros(1)}, device="cpu")



@pytest.mark.parametrize("like_dtype", [torch.bfloat16, torch.float32])
def test_reference_bf16_leaf_restores_bit_for_bit(tmp_path, like_dtype):
    """A bfloat16 leaf of the reference's ``save`` (2-byte void on disk)
    restores in the port bit for bit, as bf16 or widened to fp32 (exact);
    the port's own checkpoint of a bf16 tensor (widened to fp32 on disk)
    restores as before."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    want = torch.from_numpy(w).bfloat16()
    like = {"w": torch.zeros((5, 7), dtype=like_dtype)}
    ref_path, port_path = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(ref_path, {"w": jnp.asarray(w).astype(jnp.bfloat16)}, step=3)
    tckpt.save(port_path, {"w": want}, step=4)
    for path, step in ((ref_path, 3), (port_path, 4)):
        got, got_step = tckpt.restore(path, like, device="cpu")
        assert got_step == step and got["w"].dtype == like_dtype
        # widening bf16 to fp32 is exact, so equal fp32 bits are equal bf16 bits
        assert torch.equal(got["w"].float().view(torch.int32), want.float().view(torch.int32))


def test_restore_runs_on_the_card_unless_told(built, tmp_path):
    """Without ``device=`` a restore lands on the card, as every entry point
    does; without a card it raises instead of carrying on on the CPU."""
    (_, _), (g_t, _) = built
    path = str(tmp_path / "ck")
    tckpt.save_graph(path, g_t, 300, {})
    like = tgraph.empty_graph(300, K)
    if torch.cuda.is_available():
        got, _ = tckpt.restore_graph(path, like)
        assert got.nbr_ids.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tckpt.restore_graph(path, like)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tckpt.restore(path, {"n_valid": 0})

ARGS = ["--n", "1200", "--d", "8", "--k", str(K), "--wave", "128", "--device", "cpu"]


class _Crash(Exception):
    pass


def test_resumed_build_equals_uninterrupted(tmp_path, monkeypatch, capsys):
    whole, part = str(tmp_path / "whole"), str(tmp_path / "part")
    build_graph.main(ARGS + ["--ckpt", whole, "--ckpt-every", "2"])
    # the same build, killed right after its second checkpoint
    saves = []
    real_save = tckpt.save_graph

    def crash_after_two(path, g, next_row, cfg):
        real_save(path, g, next_row, cfg)
        saves.append(next_row)
        if len(saves) == 2:
            raise _Crash

    monkeypatch.setattr(tckpt, "save_graph", crash_after_two)
    with pytest.raises(_Crash):
        build_graph.main(ARGS + ["--ckpt", part, "--ckpt-every", "2"])
    monkeypatch.undo()
    assert tckpt.load_manifest(part)["step"] == saves[-1] < 1200
    capsys.readouterr()
    build_graph.main(ARGS + ["--ckpt", part, "--ckpt-every", "2", "--resume", "--eval"])
    out = capsys.readouterr().out
    assert f"resumed with {saves[-1]} rows already committed" in out
    like = tgraph.empty_graph(1200, K)
    a, step_a = tckpt.restore_graph(whole, like, device="cpu")
    b, step_b = tckpt.restore_graph(part, like, device="cpu")
    assert step_a == step_b == 1200
    for name in tgraph.KNNGraph._fields:
        va, vb = getattr(a, name), getattr(b, name)
        assert (va == vb) if name == "n_valid" else torch.equal(va, vb), name
    line = [s for s in out.splitlines() if s.startswith("graph recall@1=")][0]
    r1, rk = (float(t.split("=")[1]) for t in line.split()[1:])
    assert 0.5 < r1 <= 1.0 and 0.5 < rk <= 1.0


def test_resume_refused_for_parallel_builds():
    with pytest.raises(SystemExit):
        build_graph.main(ARGS + ["--parallel-shards", "2", "--resume"])


@pytest.mark.parametrize("kind", sorted(tsynth.GENERATORS))
def test_generators_match_the_reference_shapes(kind):
    n, d = 2000, 32
    got = tsynth.make(kind, torch.Generator().manual_seed(0), n, d)
    want = jsynth.make(kind, jax.random.PRNGKey(0), n, d)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    assert set(tsynth.GENERATORS) == set(jsynth.GENERATORS)
    x = got.numpy()
    if kind == "uniform":
        assert x.min() >= 0 and x.max() < 1
    if kind == "heavy_tailed":
        # row norms carry a Pareto(3) + 1 factor: a heavy right tail, and the
        # coordinate scales fall as j^(-alpha/2)
        norms = np.linalg.norm(x, axis=1)
        assert np.percentile(norms, 99.9) > 3 * np.median(norms)
        assert x[:, 0].std() > 4 * x[:, -1].std()
    if kind == "histogram":
        # non-negative rows of unit l1 norm (chi2), ~90% zeros
        assert x.min() >= 0
        np.testing.assert_allclose(x.sum(axis=1)[x.sum(axis=1) > 0], 1.0, rtol=1e-5)
        zeros = float((x == 0).mean())
        assert abs(zeros - float((np.asarray(want) == 0).mean())) < 0.01, zeros


def test_kind_flag_builds_on_each_generator(capsys):
    build_graph.main(["--n", "600", "--d", "8", "--k", "6", "--wave", "128", "--device", "cpu",
                      "--kind", "histogram", "--metric", "chi2", "--eval-sample", "100"])
    assert "metric=chi2" in capsys.readouterr().out


def test_parallel_build_rederives_a_missing_coarse_level():
    """cfg coarse, sub-builds random: no folded level survives the tree, so
    build_parallel derives one on the merged graph from fold_in(2_000_000),
    as the reference's ``derive_coarse`` does from that key."""
    x = tp.int_data(400, 8, seed=3)
    cfg = tconstruct.BuildConfig(seed_mode="coarse", coarse_landmarks=24, coarse_members=4,
                                 **CFG)
    key = jax.random.PRNGKey(4)
    g, _, lvl = tconstruct.build_parallel(
        torch.from_numpy(x), cfg, tp.JaxDraws(key), shards=2, return_coarse=True,
        sub_cfg=dataclasses.replace(cfg, seed_mode="random"), device="cpu")
    assert lvl is not None and lvl.n_landmarks == 24
    g_j = jgraph.KNNGraph(**{k: jnp.asarray(v) for k, v in convert.graph_to_numpy(g).items()})
    jcfg = jconstruct.BuildConfig(dispatch="reference", seed_mode="coarse", coarse_landmarks=24,
                                  coarse_members=4, **CFG)
    with tp.compiled_reference():
        want = jhier.derive_coarse(g_j, jnp.asarray(x), jcfg, jax.random.fold_in(key, 2_000_000))
    tp.assert_coarse_equal(lvl, want, "re-derived level")
