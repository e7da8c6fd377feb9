"""The dry run at smoke width (``repro_torch.launch.dryrun``,
``configs.cells.lower``) on a fake world of 4 ranks laid out as a (2, 2)
``("data", "model")`` mesh.

Each arch's ``full_config`` is patched to its ``smoke_config`` (as the
reference's ``perf.py`` patches configs) and the k-NN shapes are cut small.
Seven cells trace: gemma3-1b ``train_4k`` and ``decode_32k``, mixtral-8x7b
``prefill_32k`` (MoE through the static dispatch), mace ``molecule``,
deepfm ``serve_p99``, knn-lgd ``build_wave`` and ``search_4k``; each
record carries the reference's keys.  A cell that raises is recorded as
``FAIL`` and ``main`` exits 1.  The k-NN step the plan traces
(``cells.knn_build_step``: ``init_state``, one ``step``, the commit) run on
real CPU rows equals ``construct.wave_core`` at ``max_iters=1`` bit for
bit, and the planned search step equals the search at ``max_iters=1``: the
planned program is the program that runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from repro_torch import configs
from repro_torch.configs import cells
from repro_torch.core import construct, search
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import sharding

torch.set_num_threads(2)

REF_KEYS = ("chips", "hlo_gflops", "hlo_gbytes", "collective_gbytes", "collective_breakdown",
            "bytes_per_device", "arg_bytes_per_device", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "step_time_bound_s", "model_flops", "useful_ratio",
            "roofline_fraction")
CELLS = [("gemma3-1b", "train_4k"), ("gemma3-1b", "decode_32k"), ("mixtral-8x7b", "prefill_32k"),
         ("mace", "molecule"), ("deepfm", "serve_p99"), ("knn-lgd", "build_wave"),
         ("knn-lgd", "search_4k")]
SMALL_SHAPES = {
    "knn-lgd": {
        "build_wave": {"kind": "knn_build", "n_total": 4096, "d": 12, "wave": 64},
        "search_4k": {"kind": "knn_search", "n_total": 4096, "d": 12, "batch": 32},
    },
    # the LM shapes at one or two of the dry run's 512-token attention tiles
    "lm": {
        "train_4k": {"kind": "train", "seq": 512, "batch": 8},
        "prefill_32k": {"kind": "prefill", "seq": 1024, "batch": 4},
        "decode_32k": {"kind": "decode", "seq": 1024, "batch": 8},
        "long_500k": {"kind": "decode", "seq": 2048, "batch": 1},
    },
}


@pytest.fixture(scope="class")
def smoke_mesh():
    """The (2, 2) mesh over a fake world of 4, every arch at smoke width
    and the LM and k-NN shapes cut small; the world is left and the configs
    restored afterwards."""
    saved = {}
    for arch in {a for a, _ in CELLS}:
        mod = configs.get(arch)
        saved[arch] = (mod.full_config, mod.SHAPES)
        mod.full_config = mod.smoke_config
        mod.SHAPES = SMALL_SHAPES.get(arch, SMALL_SHAPES["lm"] if mod.FAMILY == "lm"
                                      else mod.SHAPES)
    mesh_lib.fake_world(4)
    try:
        yield torch.distributed.device_mesh.init_device_mesh(
            "cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        sharding.set_mesh(None)
        mesh_lib.close_group()
        for arch, (full, shapes) in saved.items():
            configs.get(arch).full_config, configs.get(arch).SHAPES = full, shapes


class TestSmokeCells:
    @pytest.mark.parametrize("arch,shape", CELLS)
    def test_cell_traces_with_the_reference_record(self, smoke_mesh, arch, shape):
        rec = dryrun.run_cell(arch, shape, smoke_mesh, "2x2")
        assert rec["status"] == "ok", rec.get("traceback")
        assert set(REF_KEYS) <= set(rec)
        assert rec["chips"] == 4 and rec["hlo_gflops"] > 0 and rec["bytes_per_device"] > 0
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert "OK" in dryrun.line(rec)
        if arch.startswith("knn-"):
            want = {"repro_torch::gather_distance": 1, "repro_torch::fused_expand": 1}
            if shape == "build_wave":
                want["repro_torch::pairwise_distance"] = 1
            assert rec["kernels"] == want
            assert rec["collective_breakdown"]  # the stats all-reduce / the lists' all-gather


def test_failing_cell_is_surfaced(monkeypatch, capsys):
    def boom(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(cells, "plan", boom)
    assert dryrun.main(["--arch", "deepfm", "--shape", "serve_p99", "--mesh", "single"]) == 1
    out = capsys.readouterr().out
    assert "deepfm x serve_p99: FAIL RuntimeError: planted" in out
    assert "done: 0 ok, 0 skipped, 1 failed" in out


@pytest.fixture(scope="module")
def world_of_one():
    mesh_lib.fake_world(1)
    try:
        yield torch.distributed.group.WORLD
    finally:
        mesh_lib.close_group()


def _grown_graph(x, n0, cfg):
    g, _ = construct.build(x[:n0], dataclasses.replace(cfg, max_iters=8), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    from repro_torch.core.graph import grow_graph

    return grow_graph(g, x.shape[0])


def test_planned_build_step_is_wave_core(world_of_one):
    x = torch.from_numpy(tp.int_data(400, 8, seed=3))
    cfg = construct.BuildConfig(k=6, wave=64, n_seed_init=64, beam=12, n_seeds=4,
                                hash_slots=256, max_iters=1)
    g = _grown_graph(x, 300, cfg)
    seeds = torch.from_numpy(np.random.RandomState(1).randint(0, 300, (64, 4))).int()
    pos, n_real = 300, 64
    want_g, want_stats, _ = construct.wave_core(
        g, x, pos, seeds, construct.zero_stats(device="cpu"), cfg, n_real=n_real)
    got_g, total = cells.knn_build_step(g, x, pos, n_real, seeds, cfg, world_of_one)
    for name, a, b in zip(got_g._fields, got_g, want_g):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name
    assert total.tolist() == [int(want_stats.n_comps), int(want_stats.n_inserted_edges)]


def test_planned_search_step_is_the_search(world_of_one):
    x = torch.from_numpy(tp.int_data(300, 8, seed=4))
    cfg = construct.BuildConfig(k=6, wave=64, n_seed_init=64, beam=12, n_seeds=4,
                                hash_slots=256)
    g = _grown_graph(x, 300, cfg)
    scfg = dataclasses.replace(cfg.search_config(), max_iters=1)
    q = x[:16] + 1
    seeds = torch.from_numpy(np.random.RandomState(2).randint(0, 300, (16, 4))).int()
    want = search.search(g, x, q, scfg, seeds=seeds, device="cpu")
    ids, dists = cells.knn_search_step(g, x, q, seeds, scfg, world_of_one)
    assert torch.equal(ids, want.ids) and torch.equal(dists, want.dists)
