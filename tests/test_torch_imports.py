"""Port isolation: ``repro_torch`` imports neither JAX nor the JAX package,
its entry points never fall back to the CPU on their own, and the CPU path
launches no kernel."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as device_lib
from repro_torch.core import brute, construct, search
from repro_torch.kernels import _cuda, distance, expand, gather_dist, ops, tile_topk
from repro_torch.launch import build_graph

torch.set_num_threads(2)

SRC = Path(__file__).resolve().parents[1] / "src"
ROOT = SRC.parent


def _modules():
    pkg = SRC / "repro_torch"
    return sorted(
        "repro_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py") if p.name != "__init__.py"
    )


def test_no_jax_or_reference_package_in_sys_modules():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= len(_modules())


def test_isolation_check_covers_every_module():
    """The subprocess above imports every module of the package, the mesh,
    checkpoint, distributed, build-variant and recommender modules among
    them, the training and GNN modules, the LM modules and configs,
    placement, and the dry run's cells, roofline, dryrun and perf."""
    mods = _modules()
    for name in ("repro_torch.core.distributed", "repro_torch.launch.mesh",
                 "repro_torch.train.checkpoint", "repro_torch.configs.knn_olg",
                 "repro_torch.data.synthetic", "repro_torch.launch.build_graph",
                 "repro_torch.models.common", "repro_torch.models.embedding",
                 "repro_torch.models.recsys", "repro_torch.configs.recsys_shapes",
                 "repro_torch.configs.deepfm", "repro_torch.configs.xdeepfm",
                 "repro_torch.configs.bst", "repro_torch.configs.mind",
                 "repro_torch.data.recsys_data", "repro_torch.convert",
                 "repro_torch.train.optimizer", "repro_torch.train.compress",
                 "repro_torch.train.train_loop", "repro_torch.data.loader",
                 "repro_torch.data.graphs", "repro_torch.models.mace",
                 "repro_torch.configs.mace_cfg", "repro_torch.launch.train",
                 "repro_torch.models.attention", "repro_torch.models.moe",
                 "repro_torch.models.transformer", "repro_torch.configs.lm_shapes",
                 "repro_torch.configs.gemma3_1b", "repro_torch.configs.stablelm_1_6b",
                 "repro_torch.configs.qwen2_5_3b", "repro_torch.configs.mixtral_8x7b",
                 "repro_torch.configs.arctic_480b", "repro_torch.models.sharding",
                 "repro_torch.launch.placement", "repro_torch.configs.cells",
                 "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
                 "repro_torch.launch.perf"):
        assert name in mods, name


def _assert_imports_no_jax(path):
    text = (ROOT / path).read_text()
    for line in text.splitlines():
        words = line.replace(",", " ").split()
        if words[:1] in (["import"], ["from"]):
            assert "jax" not in words[1] and words[1].split(".")[0] != "repro", line


def test_chip_smoke_imports_no_jax():
    _assert_imports_no_jax("chip_smoke.py")


EXAMPLES = ("retrieval_serving_torch.py", "molecule_graphs_torch.py", "train_lm_torch.py",
            "quickstart_torch.py", "lifecycle_torch.py", "parallel_build_torch.py")


@pytest.mark.parametrize("path", [f"examples/{name}" for name in EXAMPLES]
                         + ["src/repro_torch/configs/__init__.py",
                            "src/repro_torch/__init__.py", "src/repro_torch/core/__init__.py"])
def test_example_and_registry_sources_import_no_jax(path):
    _assert_imports_no_jax(path)


def test_example_and_registry_import_no_jax():
    """The port's examples, registry and facades (every name of
    ``repro_torch.__all__`` and ``repro_torch.core.__all__``), imported in a
    fresh process, bring in neither JAX nor the reference package."""
    examples = [str(ROOT / "examples" / f) for f in EXAMPLES]
    code = (
        "import importlib.util, sys\n"
        "import repro_torch, repro_torch.core\n"
        "import repro_torch.configs as c\n"
        "[c.get(a) for a in c.names()]\n"
        "[getattr(repro_torch, n) for n in repro_torch.__all__]\n"
        "[getattr(repro_torch.core, n) for n in repro_torch.core.__all__]\n"
        "assert repro_torch.build is repro_torch.core.construct.build\n"
        f"for ex in {examples!r}:\n"
        "    spec = importlib.util.spec_from_file_location('ex', ex)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    x = torch.rand(300, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        construct.build(x, construct.BuildConfig(k=4, wave=32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        brute.brute_force_knn(x, x[:3], 4)
    g = brute.exact_seed_graph(x, 32, 4, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search.search(g, x, x[:3], search.SearchConfig(k=4, beam=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_graph.main(["--n", "300", "--d", "4"])
    assert device_lib.resolve("cpu") == torch.device("cpu")


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    x = torch.from_numpy(np.random.RandomState(0).rand(400, 6).astype(np.float32))
    g, _ = construct.build(x, construct.BuildConfig(k=6, wave=64, beam=12, max_iters=10),
                           device="cpu")
    brute.brute_force_knn(x, x[:20], 5, device="cpu")
    assert g.n_valid == 400
    assert ops.launch_counts() == {name: 0 for name in _cuda.LAUNCHES}


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.rand(50, 8)
    idx = torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gather_dist.gather_distance(x[:4], x, idx)
    x8, scale = x.to(torch.int8), torch.ones(50)
    with pytest.raises(ValueError, match="CUDA"):
        gather_dist.gather_distance(x[:4], x8, idx, sq_norms=scale, row_scale=scale)
    with pytest.raises(ValueError, match="row_scale"):
        gather_dist.gather_distance(x[:4], x8, idx, sq_norms=scale)
    with pytest.raises(ValueError, match="sq_norms"):
        gather_dist.gather_distance(x[:4], x8, idx, row_scale=scale)
    with pytest.raises(ValueError, match="CUDA"):
        distance.pairwise_distance(x[:4], x)
    with pytest.raises(ValueError, match="CUDA"):
        tile_topk.tile_topk(x[:4], torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.int32), 0, 8)
    with pytest.raises(ValueError, match="CUDA"):
        expand.fused_expand(
            x[:4], x, idx, idx, torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.bool),
            torch.full((4, 16), -1, dtype=torch.int32), torch.zeros(4, 16),
        )
    assert ops.launch_counts() == {name: 0 for name in _cuda.LAUNCHES}


def test_kernel_library_paths_are_keyed_by_source():
    paths = {name: _cuda.library_path(name) for name in _cuda.SOURCES}
    for name, path in paths.items():
        assert path.parent == _cuda.BUILD_DIR and path.name.startswith(name + "-")
        assert (_cuda.CSRC / f"{name}.cu").exists()
    assert len(set(paths.values())) == len(paths)
    assert _cuda.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
