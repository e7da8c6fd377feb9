"""The port's sharded paths (``core.distributed``, the mesh branches of
``merge_subgraphs`` and ``build_parallel``) against the reference's mesh.

Both worlds run in subprocesses started together: the reference over 4
host devices (``--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` runs it), in three processes, and the port as
4 gloo ranks on the CPU (``tests/torch_distributed_world.py``), on the same
integer rows with the reference's keys replayed.  Shard graphs, search
answers, merged graphs and counters must be equal bit for bit, and equal on
every rank.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT = 300

# the shard steps, the search and a 4-way build_parallel on the mesh
REF_PREAMBLE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import brute, construct, distributed
from repro.kernels import compat

inp = dict(np.load(sys.argv[1]))
x, q = jnp.asarray(inp["x"]), jnp.asarray(inp["q"])
cfg = construct.BuildConfig(k=6, wave=32, n_seed_init=32, beam=12, n_seeds=4,
                            hash_slots=256, max_iters=12, dispatch="reference")
n = x.shape[0]
n_local = n // 4
out = {}

def keep(prefix, g):
    for f in g._fields:
        out[prefix + f] = np.asarray(getattr(g, f))
"""

REF_STEPS = REF_PREAMBLE + r"""
mesh = compat.make_mesh((4,), ("data",))
ax = ("data",)
seed = compat.shard_map(
    lambda xs: brute.exact_seed_graph(xs, cfg.n_seed_init, cfg.k, cfg.metric,
                                      rev_capacity=cfg.rev_cap, dispatch="reference"),
    mesh=mesh, in_specs=(P(ax, None),), out_specs=distributed.graph_pspec(ax))
g = jax.jit(seed)(x)
step = jax.jit(distributed.make_distributed_build_step(mesh, cfg))
key = jax.random.PRNGKey(0)
pos, comps, edges = cfg.n_seed_init, 0.0, 0.0
while pos < n_local:
    nr = min(cfg.wave, n_local - pos)
    key, sk = jax.random.split(key)
    g, c, e = step(g, x, jnp.asarray(pos, jnp.int32), jnp.asarray(nr, jnp.int32), sk)
    comps, edges, pos = comps + float(c), edges + float(e), pos + nr
keep("step_", g)
out["step_comps"], out["step_edges"] = comps, edges
search = jax.jit(distributed.make_distributed_search(mesh, cfg.search_config()))
ids, d = search(g, x, q, jax.random.PRNGKey(9))
out["search_ids"], out["search_d"] = np.asarray(ids), np.asarray(d)
ids, d = search(g._replace(alive=g.alive.at[:n_local].set(False)), x, q, jax.random.PRNGKey(9))
out["blank_ids"], out["blank_d"] = np.asarray(ids), np.asarray(d)
g, st = construct.build_parallel(x, cfg, jax.random.PRNGKey(1), shards=4, refine_rounds=1,
                                 mesh=mesh)
keep("par4_", g)
out["par4_comps"] = int(st.n_comps)
np.savez(sys.argv[2], **out)
"""

# a 2-way mesh over the first half of the rows
REF_PAIR = REF_PREAMBLE + r"""
g, st = construct.build_parallel(x[: n // 2], cfg, jax.random.PRNGKey(2), shards=2,
                                 refine_rounds=1, mesh=compat.make_mesh((2,), ("data",)))
keep("par2_", g)
out["par2_comps"] = int(st.n_comps)
np.savez(sys.argv[2], **out)
"""

# the coarse-seeded sub-builds and mesh fold
REF_COARSE = REF_PREAMBLE + r"""
cfg_c = dataclasses.replace(cfg, seed_mode="coarse", coarse_landmarks=16, coarse_members=4)
g, st, lvl = construct.build_parallel(x, cfg_c, jax.random.PRNGKey(3), shards=4,
                                      refine_rounds=1, mesh=compat.make_mesh((4,), ("data",)),
                                      return_coarse=True)
keep("parc_", g)
out["parc_comps"] = int(st.n_comps)
out["parc_landmarks"] = np.asarray(lvl.landmark_rows)
np.savez(sys.argv[2], **out)
"""

N_LOCAL = 96


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(reference outputs, port outputs): every process started at once."""
    tmp = tmp_path_factory.mktemp("dist")
    rs = np.random.RandomState(0)
    inp = tmp / "in.npz"
    np.savez(inp, x=rs.randint(0, 16, (4 * N_LOCAL, 8)).astype(np.float32),
             q=rs.randint(0, 16, (16, 8)).astype(np.float32))
    procs = {}
    for name, script in (("steps", REF_STEPS), ("pair", REF_PAIR), ("coarse", REF_COARSE)):
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", script, str(inp), str(tmp / f"ref_{name}.npz")],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs["port"] = subprocess.Popen(
        [sys.executable, str(HERE / "torch_distributed_world.py"), str(inp),
         str(tmp / "port.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for name, p in procs.items():
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"{name}: {err[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    ref = {}
    for name in ("steps", "pair", "coarse"):
        ref.update(np.load(tmp / f"ref_{name}.npz"))
    return ref, dict(np.load(tmp / "port.npz"))


def _assert_equal(worlds, prefix):
    ref, port = worlds
    keys = sorted(k for k in ref if k.startswith(prefix))
    assert keys
    for k in keys:
        np.testing.assert_array_equal(port[k], np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("prefix", ["step_", "search_", "blank_", "par4_", "par2_", "parc_"])
def test_matches_reference_mesh(worlds, prefix):
    """Shard steps (from per-shard exact seed graphs), the scatter-gather
    search, the search with shard 0 blanked, and build_parallel on a 4-,
    a 2- and a coarse-seeded 4-way group: bit for bit, counters too."""
    _assert_equal(worlds, prefix)


def test_blanked_shard_serves_none_of_its_rows(worlds):
    _, port = worlds
    blank = port["blank_ids"]
    assert not np.any((blank >= 0) & (blank < N_LOCAL))
    assert np.all(blank >= 0)  # the three live shards still fill every answer
    assert np.all(np.diff(port["search_d"], axis=1) >= 0)


def test_seed_graphs_and_coarse_root(worlds):
    ref, port = worlds
    assert bool(port["init_ok"])
    np.testing.assert_array_equal(port["parc_landmarks"], ref["parc_landmarks"])
    rows = port["parc_landmarks"]
    assert rows.min() >= 0 and rows.max() < 4 * N_LOCAL


def test_a_failing_rank_fails_the_world(tmp_path):
    """A rank that raises before its first collective: the world exits
    non-zero, well inside the collectives' own timeout, naming the error."""
    rs = np.random.RandomState(1)
    inp = tmp_path / "in.npz"
    np.savez(inp, x=rs.randint(0, 16, (4 * N_LOCAL, 8)).astype(np.float32),
             q=rs.randint(0, 16, (4, 8)).astype(np.float32))
    out = subprocess.run(
        [sys.executable, str(HERE / "torch_distributed_world.py"), str(inp),
         str(tmp_path / "out.npz"), "fail"],
        env=_env(), capture_output=True, text=True, timeout=100)
    assert out.returncode != 0
    assert "rank 2 fails before its first collective" in out.stderr
    assert not (tmp_path / "out.npz").exists()
