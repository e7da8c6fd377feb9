"""The running top-k of an exact tile (``kernels.ref.tile_topk``, the plain
version of ``csrc/tile_topk.cu``) on the CPU.

* The plain version equals the sequence ``core.brute`` ran inline before it
  (``torch.where`` mask, concatenation of the best and the tile,
  ``ref.topk_smallest``), bit for bit, over two chained tiles: heavy ties,
  ±0.0, ±inf and NaN of both signs, every mask (``n_valid`` inside the
  tile, ``alive``, ``exclude_ids``), a short last tile, fewer valid
  candidates than k (the -1 padding) and k above the tile's width.
* ``ops.tile_topk`` routes a CPU tensor to it and launches nothing.
* The registered operator's fake form gives (m, k) float32 and int32; its
  cost function counts the tile, the best in and out and the masks' bytes;
  the wrapper refuses a k above ``MAX_K`` before anything else.

``tests/test_torch_cuda.py`` holds the kernel against this plain version on
the card.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import device as device_lib
from repro_torch.kernels import _cuda, ops, ref
from repro_torch.kernels import tile_topk as tile_topk_lib

torch.set_num_threads(2)

KINDS = ["ties", "specials", "gauss"]
MASKS = ["none", "n_valid", "alive", "exclude", "all", "short", "few"]


def _old_inline(dt, best_d, best_i, lo, n_valid, alive, excl, short):
    """``core/brute.py``'s loop body before the kernel: ``alive`` is the
    whole (n,) flag vector, ``excl`` the (m,) excluded ids."""
    m, tile = dt.shape
    ids = lo + torch.arange(tile, dtype=torch.int32)[None, :]
    mask = ids < n_valid
    if alive is not None:
        al = alive[lo:lo + tile]
        if short:
            al = torch.cat([al, al.new_zeros(short)])
        mask = mask & al[None, :]
    if excl is not None:
        mask = mask & (ids != excl[:, None])
    dt = torch.where(mask, dt, float("inf"))
    cat_d = torch.cat([best_d, dt], dim=1)
    cat_i = torch.cat([best_i, ids.expand(m, tile)], dim=1)
    return ref.topk_smallest(cat_d, cat_i, k=best_d.shape[1])


SPECIAL_BITS = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00000, 0x3F800000, 0xBF800000], dtype=np.uint32)


def tile_values(kind, shape, seed):
    """A tile's distances: small integers (``ties``), integers mixed with
    ±0.0, ±inf and NaN of both signs (``specials``), or N(0, 1)."""
    rng = np.random.RandomState(seed)
    if kind == "gauss":
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))
    a = rng.randint(0, 4, shape).astype(np.float32)
    if kind == "specials":
        pick = rng.rand(*shape) < 0.4
        special = SPECIAL_BITS[rng.randint(0, len(SPECIAL_BITS), shape)].view(np.float32)
        a = np.where(pick, special, a)
    return torch.from_numpy(np.ascontiguousarray(a))


def mask_problem(mask, n, tile, m, seed):
    """(n_valid, alive (n,), excl (m,)) of one mask case over n rows."""
    rng = np.random.RandomState(seed)
    n_valid, alive, excl = n, None, None
    if mask in ("n_valid", "all"):
        n_valid = tile + tile // 2 + 1  # inside the second tile
    if mask == "few":
        n_valid = 3  # fewer valid candidates than most k
    if mask in ("alive", "all", "short"):
        alive = torch.from_numpy(rng.rand(n) < 0.6)
    if mask in ("exclude", "all"):
        excl = torch.from_numpy(rng.randint(0, n, m).astype(np.int32))
        excl[0] = 1  # a column of the first tile
    return n_valid, alive, excl


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k,tile", [(1, 37), (4, 37), (10, 64), (10, 5), (33, 40)])
def test_plain_equals_the_old_inline_sequence(k, tile, kind, mask):
    m = 6
    n = 2 * tile - (7 if mask == "short" and tile > 7 else 0)
    n_valid, alive, excl = mask_problem(mask, n, tile, m, seed=k + tile)
    want_d = got_d = torch.full((m, k), float("inf"))
    want_i = got_i = torch.full((m, k), -1, dtype=torch.int32)
    for t in range(2):
        lo = t * tile
        short = lo + tile - n if lo + tile > n else 0
        dt = tile_values(kind, (m, tile), seed=10 * t + k)
        want_d, want_i = _old_inline(dt, want_d, want_i, lo, n_valid, alive, excl, short)
        got_d, got_i = ops.tile_topk(
            dt, got_d, got_i, lo, n_valid,
            alive=None if alive is None else alive[lo:lo + tile], exclude_ids=excl)
        assert torch.equal(got_i, want_i), f"tile {t}"
        assert torch.equal(got_d.view(torch.int32), want_d.view(torch.int32)), f"tile {t}"
    if mask == "few" and k > 3:
        assert bool((got_i[:, 3:] == -1).all()) and bool(torch.isinf(got_d[:, 3:]).all())


def test_exclude_ids_of_any_integer_type():
    """``core.brute`` hands int64 excluded ids; int32 ones select the same."""
    dt = tile_values("ties", (5, 30), 3)
    best_d, best_i = torch.full((5, 4), float("inf")), torch.full((5, 4), -1, dtype=torch.int32)
    excl = torch.tensor([0, 3, 29, 31, 7], dtype=torch.int32)
    a = ref.tile_topk(dt, best_d, best_i, 0, 30, exclude_ids=excl)
    b = ref.tile_topk(dt, best_d, best_i, 0, 30, exclude_ids=excl.long())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cpu_route_launches_nothing():
    ops.reset_launch_counts()
    dt = tile_values("gauss", (4, 50), 1)
    ops.tile_topk(dt, torch.full((4, 3), float("inf")), torch.full((4, 3), -1, dtype=torch.int32),
                  0, 50)
    assert ops.launch_counts() == {name: 0 for name in _cuda.LAUNCHES}


def _op_args(m=6, T=40, k=5, with_masks=True):
    dt = tile_values("gauss", (m, T), 2)
    best_d = torch.full((m, k), float("inf"))
    best_i = torch.full((m, k), -1, dtype=torch.int32)
    alive = torch.ones(T - 3, dtype=torch.bool) if with_masks else None
    excl = torch.arange(m, dtype=torch.int64) if with_masks else None
    return dt, best_d, best_i, alive, excl


def test_fake_form_gives_the_plain_versions_shapes_and_dtypes():
    dt, best_d, best_i, alive, excl = _op_args()
    want = ref.tile_topk(dt, best_d, best_i, 80, 100, alive=alive, exclude_ids=excl)
    ops.reset_launch_counts()
    with FakeTensorMode() as mode, device_lib.card_program():
        f = [None if t is None else mode.from_tensor(t) for t in (dt, best_d, best_i, alive, excl)]
        got = ops.tile_topk(*f[:3], 80, 100, alive=f[3], exclude_ids=f[4])
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert [t.dtype for t in got] == [torch.float32, torch.int32]
    assert ops.launch_counts() == {name: 0 for name in _cuda.LAUNCHES}


@pytest.mark.parametrize("with_masks", [False, True])
def test_cost_counts_the_tile_the_best_and_the_masks(with_masks):
    m, T, k = 6, 40, 5
    args = _op_args(m, T, k, with_masks)
    c = tile_topk_lib.cost(*args, 0, T)
    masks = (T - 3) + m * 8 if with_masks else 0
    assert c["flops"] == {torch.float32: 0.0}
    assert c["bytes_read"] + c["bytes_written"] == float(m * T * 4 + 2 * m * k * 8 + masks)
    assert c["bytes_written"] == float(m * k * 8)
    assert _cuda.COSTS[tile_topk_lib.TILE_TOPK_OP] is tile_topk_lib.cost


def test_wrapper_refuses_k_above_its_largest_then_cpu_tensors():
    dt = tile_values("gauss", (2, 8), 4)
    k = tile_topk_lib.MAX_K + 1
    big = (torch.full((2, k), float("inf")), torch.full((2, k), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match=f"k={k}"):
        tile_topk_lib.tile_topk(dt, *big, 0, 8)
    best = (torch.full((2, 3), float("inf")), torch.full((2, 3), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        tile_topk_lib.tile_topk(dt, *best, 0, 8)
    assert ops.launch_counts() == {name: 0 for name in _cuda.LAUNCHES}
