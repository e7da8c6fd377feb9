"""The process group of a sharded deployment and the production meshes
(counterpart of ``repro.launch.mesh``).

JAX's mesh is one controller over many devices; ``torch.distributed`` is
SPMD: one process per shard, every process calling the same functions.
``init_group`` joins this process to a group of ``world_size`` ranks at
``tcp://localhost:<port>`` and returns it; ``core.distributed`` takes that
group where the reference takes a mesh.

The backend is the caller's choice, never picked here:

* ``"nccl"`` when each rank has a card of its own (rank r uses card r);
  asking for more ranks than cards raises;
* ``"gloo"`` for the CPU tests, and for several ranks sharing one card,
  where its collectives stage the few tensors they move through the host
  (``core.distributed`` does that).

Tensors stay on the device the caller gives them.

``make_production_mesh`` lays the reference's production meshes, (16, 16)
``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")``, over the
current world of 256 or 512 ranks as a ``DeviceMesh``.  Placement can be
planned without that many devices: ``fake_world`` joins this process, as
rank 0, to a fake process group of any size, whose collectives do nothing,
and parameters made under ``FakeTensorMode`` and placed on its mesh
(``models.sharding.place``) allocate nothing.  Nothing here runs when the
module is imported.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(rank: int, world_size: int, backend: str, port: int, *,
               timeout_s: float = 600.0):
    """Join the default process group as ``rank`` of ``world_size`` over
    ``backend`` at ``tcp://localhost:<port>`` and return it (the group every
    ``core.distributed`` call takes).  A collective that waits longer than
    ``timeout_s`` raises instead of hanging."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"nccl needs a card per rank: {world_size} ranks, {cards} cards "
                "(several ranks on one card take gloo)")
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the current world (256 ranks for
    one pod, 512 for two), rank r at the reference's row-major place: a
    planning mesh of CPU devices, as a ``fake_world`` provides."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION_MESHES[multi_pod]
    need = 1
    for s in shape:
        need *= s
    if not dist.is_initialized() or dist.get_world_size() != need:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh needs a world of {need} "
                         f"ranks, this process is in one of {have} (fake_world plans it)")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def fake_world(world_size: int):
    """Join this process, as rank 0, to a fake process group of
    ``world_size`` ranks and return it; its collectives complete at once and
    move nothing.  ``close_group()`` leaves it.

    The store comes from ``torch.testing._internal.distributed.fake_pg``,
    a private module of PyTorch (the ``"fake"`` backend registers on its
    import); it may change between releases, and only planning uses it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("this process is already in a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    return dist.group.WORLD


def close_group() -> None:
    """Leave the default process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class DPGroups:
    """This rank's two groups of the reference's ``(pod, data)`` mesh: the
    ranks of its pod (``data``) and the ranks at its place in every pod
    (``pod``).  Rank r is pod ``r // n_data``, place ``r % n_data``, the
    reference's row-major device order, so its rows of a global batch are
    the r-th of ``n_pods * n_data`` equal blocks (``local_rows``)."""

    data: object
    pod: object
    n_pods: int
    n_data: int
    rank: int

    def local_rows(self, batch: dict) -> dict:
        world = self.n_pods * self.n_data
        return {k: v[self.rank * (v.shape[0] // world):(self.rank + 1) * (v.shape[0] // world)]
                for k, v in batch.items()}


def dp_groups(n_pods: int) -> DPGroups:
    """The data and pod groups of ``n_pods`` pods over the world, whose
    size n_pods must divide.  Every rank must call this,
    in the same order as its other ``new_group`` calls: each group is made
    on every rank, the ones it is not in included."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_pods:
        raise ValueError(f"{n_pods} pods do not divide a world of {world}")
    n_data = world // n_pods
    data = pod = None
    for p in range(n_pods):
        g = dist.new_group([p * n_data + i for i in range(n_data)])
        data = g if rank // n_data == p else data
    for i in range(n_data):
        g = dist.new_group([p * n_data + i for p in range(n_pods)])
        pod = g if rank % n_data == i else pod
    return DPGroups(data=data, pod=pod, n_pods=n_pods, n_data=n_data, rank=rank)
