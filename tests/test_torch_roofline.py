"""The dry run's record on the H100's terms (``repro_torch.launch.roofline``)
and the three kernels as registered operators.

* ``collective_bytes`` equals the reference's on synthetic HLO lines of
  every kind (all-gather, all-reduce, reduce-scatter, all-to-all and a
  collective-permute ``-start``/``-done`` pair) at group sizes 2, 16 and
  256, each line given to the port as the collective it describes.
* The per-rank accounting (``CostMode``) of a sharded product on a fake
  world counts one rank's FLOPs: 2·M·K·N/m with K split over a 'model'
  axis of m ranks, where ``FlopCounterMode`` counts the global product.
* The registered kernels' fake forms give the plain versions' shapes and
  dtypes; their cost functions equal their formulas at one shape each; a
  k-NN step traced under the accounting is charged through them.
* The rates are ``launch.profile_build``'s.

``tests/test_torch_cuda.py`` runs the operators on the card
(``torch.library.opcheck``, the launch counters counting through them).
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import roofline as jroof
from repro_torch import device as device_lib
from repro_torch.kernels import _cuda, distance, expand, gather_dist, ops, ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import profile_build, roofline
from repro_torch.models import sharding

torch.set_num_threads(2)

GROUPS = (2, 16, 256)


def _hlo(kind: str, shape: str, g: int, variant: str = "") -> str:
    return (f"  %c = {shape} {kind}{variant}(f32[8]{{0}} %p), "
            f"replica_groups=[{512 // g},{g}]<=[512], dimensions={{0}}")


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("kind,shape,nbytes", [
    ("all-gather", "f32[16,128]{1,0}", 16 * 128 * 4),
    ("all-reduce", "bf16[4096]{0}", 4096 * 2),
    ("reduce-scatter", "f32[64,8]{1,0}", 64 * 8 * 4),
    ("all-to-all", "s32[256,4]{1,0}", 256 * 4 * 4),
    ("collective-permute", "f32[1000]{0}", 4000),
])
def test_collective_bytes_match_reference(kind, shape, nbytes, g):
    want = jroof.collective_bytes(_hlo(kind, shape, g))
    got = roofline.collective_bytes([roofline.Collective(kind, (nbytes,), g)])
    assert got == pytest.approx(want)


@pytest.mark.parametrize("g", GROUPS)
def test_collective_start_done_pair_matches_reference(g):
    start = _hlo("collective-permute", "(f32[64]{0}, f32[64]{0}, u32[], u32[])", g, "-start")
    done = _hlo("collective-permute", "f32[64]{0}", g, "-done")
    ag = _hlo("all-gather", "f32[32]{0}", g)
    want = jroof.collective_bytes("\n".join([start, done, ag]))
    got = roofline.collective_bytes([
        roofline.Collective("collective-permute", (256, 256, 4, 4), g, "-start"),
        roofline.Collective("collective-permute", (256,), g, "-done"),
        roofline.Collective("all-gather", (128,), g)])
    assert got == pytest.approx(want) and got["_count"] == 2


def test_rates_are_profile_builds():
    assert roofline.HBM_BW == profile_build.HBM_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_FLOPS[torch.bfloat16] == profile_build.FLOP_PER_S["bf16"] == 989e12
    assert roofline.PEAK_FLOPS[torch.float32] == profile_build.FLOP_PER_S["fp32"] == 67e12
    assert roofline.NET_BW == 50e9 and roofline.HBM_BYTES == 80 * 2**30


def test_sharded_product_counts_one_ranks_flops():
    """(M, K) x (K, N), K split over 'model' of m = 4 ranks: 2·M·K·N/m FLOPs
    on rank 0 and one all-reduce of its (M, N) partial sum; the bf16
    product counts at bf16."""
    M, K, N, m = 64, 128, 32, 4
    mesh_lib.fake_world(8)
    try:
        mesh = torch.distributed.device_mesh.init_device_mesh(
            "cpu", (2, m), mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            a = sharding.place(torch.empty(M, K, dtype=torch.bfloat16), (None, "model"), mesh)
            b = sharding.place(torch.empty(K, N, dtype=torch.bfloat16), ("model", None), mesh)
            mode = roofline.CostMode()
            mode.hold([a, b])
            with mode:
                c = (a @ b).full_tensor()
            low = mode.lowered(sharding.local_bytes([a, b]))
    finally:
        mesh_lib.close_group()
    assert tuple(c.shape) == (M, N)
    assert low.flops == {torch.bfloat16: 2.0 * M * K * N / m}
    assert low.arg_bytes == (M * K + K * N) * 2 // m
    assert roofline.collective_bytes(low.collectives)["all-reduce"] == pytest.approx(
        2.0 * M * N * 2 * (m - 1) / m)
    rec = roofline.analyze(low, mesh, model_flops=2.0 * M * K * N)
    assert rec["chips"] == 8 and rec["fits_80gib"]
    assert rec["t_compute_s"] == pytest.approx(2.0 * M * K * N / m / 989e12)
    assert rec["useful_ratio"] == pytest.approx(m / 8)


def _kernel_args(B=6, C=5, d=16, n=40, H=64, e=4):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, d, generator=g)
    q = torch.randn(B, d, generator=g)
    idx = torch.randint(-1, n, (B, C), generator=g, dtype=torch.int32)
    beam = (torch.randint(0, n, (B, e), generator=g, dtype=torch.int32),
            torch.rand(B, e, generator=g), torch.zeros(B, e, dtype=torch.bool))
    hashes = (torch.full((B, H), -1, dtype=torch.int32), torch.full((B, H), float("inf")))
    return q, x, idx, beam, hashes


def test_fake_forms_have_the_plain_versions_shapes_and_dtypes():
    q, x, idx, beam, hashes = _kernel_args()
    want = [ref.pairwise_distance(q, x, "l2"), ref.gather_distance(q, x, idx, "l2"),
            *expand.expand_reference(q, x, idx, *beam, *(h.clone() for h in hashes))]
    with FakeTensorMode() as mode, device_lib.card_program():
        fq, fx, fidx = (mode.from_tensor(t) for t in (q, x, idx))
        fbeam = [mode.from_tensor(t) for t in beam]
        fhash = [mode.from_tensor(t) for t in hashes]
        got = [ops.pairwise_distance(fq, fx, "l2"), ops.gather_distance(fq, fx, fidx, "l2"),
               *ops.expand_step(fq, fx, fidx, *fbeam, *fhash)]
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert ops.launch_counts() == {name: 0 for name in _cuda.LAUNCHES}


def test_cost_functions_equal_their_formulas():
    B, C, d, n, e, P = 6, 5, 16, 40, 4, 8
    q, x, idx, beam, hashes = _kernel_args(B, C, d, n, e=e)
    sq = torch.zeros(n)
    c = distance.cost(q, x, sq, "l2")
    assert c == {"flops": {torch.float32: 2.0 * B * n * d},
                 "bytes_read": float(B * d * 4 + n * d * 4 + n * 4),
                 "bytes_written": float(B * n * 4)}
    bq, bx = q.bfloat16(), x.bfloat16()
    assert distance.cost(bq, bx, None, "ip")["flops"] == {torch.bfloat16: 2.0 * B * n * d}
    assert distance.cost(bq, bx, None, "l1")["flops"] == {torch.float32: 2.0 * B * n * d}
    row = d * 4 + 4  # a row and its cached norm
    assert gather_dist.cost(q, x, idx, sq, None, "l2") == {
        "flops": {torch.float32: 2.0 * B * C * d},
        "bytes_read": float(B * d * 4 + B * C * 4 + B * C * row),
        "bytes_written": float(B * C * 4)}
    assert gather_dist.cost(q, x.to(torch.int8), idx, sq, sq, "l2")["bytes_read"] == float(
        B * d * 4 + B * C * 4 + B * C * (d + 8))
    beam_bytes = B * e * 9
    assert expand.cost(q, x, idx, *beam, *hashes, sq, None, "l2", P) == {
        "flops": {torch.float32: 2.0 * B * C * d},
        "bytes_read": float(B * d * 4 + B * C * 4 + B * C * row + B * C * P * 8 + beam_bytes),
        "bytes_written": float(B * C * 8 + beam_bytes + B * 4)}


def test_knn_step_is_charged_through_the_kernels():
    """A one-iteration search traced on fakes under the accounting calls
    each of its two kernels once and is charged by their cost functions."""
    from repro_torch.core import search
    from repro_torch.core.graph import empty_graph

    cfg = search.SearchConfig(k=4, beam=8, hash_slots=64, max_iters=4)
    with FakeTensorMode():
        g = empty_graph(200, 4)._replace(n_valid=200)
        x, q = torch.empty(200, 16), torch.empty(6, 16)
        seeds = torch.zeros(6, cfg.n_seeds, dtype=torch.int32)
        mode = roofline.CostMode()
        mode.hold([g, x, q, seeds])
        with mode, device_lib.card_program():
            st = search.step(g, x, q, search.init_state(g, x, q, seeds, cfg), cfg)
    assert tuple(st.beam_ids.shape) == (6, 8)
    assert mode.kernels == {"repro_torch::gather_distance": 1, "repro_torch::fused_expand": 1}
    C = 4 + 8  # k forward + 2k reverse candidates
    assert mode.flops[torch.float32] >= 2.0 * 6 * (cfg.n_seeds + C) * 16
