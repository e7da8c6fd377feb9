"""MACE, higher-order equivariant message passing (arXiv:2206.07697);
counterpart of ``repro.models.mace``.

Configuration: n_layers=2, d_hidden=128, l_max=2, correlation order ν=3,
n_rbf=8, E(3) equivariance.  The equivariant features are Cartesian tensors,
as in the reference: scalars (N, C), vectors (N, 3, C) and traceless
symmetric rank-2 tensors (N, 3, 3, C), so every contraction of the A → B
product basis is a dense einsum, and rotations act on the Cartesian
indices.

Message passing sums over an explicit edge list: the reference's
``jax.ops.segment_sum`` is ``index_add`` here.  On CUDA its atomic adds
land in any order, so sums may differ between runs in the last bits.

The reference's rank-1 and rank-2 node features (``h1``, ``h2``, updated
through ``mix1``/``mix2``) reach no readout: only the scalar channel feeds
the messages and the readouts, so XLA drops them under ``jit``.  This port
computes neither them nor their rank-1/2 basis products: ``forward`` takes
only the rank-0 products (``_scalar_basis``).  ``mix1``/``mix2`` stay in the
parameter tree (with zero gradients, as in the reference).

Parameters are a flat dict of tensors; ``init_params`` draws them in a
fixed order from one generator (the numbers differ from the reference's:
the tests carry its parameters across with ``convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models import common, sharding

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2  # Cartesian ranks carried: 0, 1, 2
    correlation: int = 3  # ν — highest product order in the B-basis
    n_rbf: int = 8
    n_species: int = 8
    r_cut: float = 5.0
    d_node_feat: int = 0  # citation-graph shapes: raw feature width (0 = none)
    n_classes: int = 0  # >0 = node-classification head; 0 = energy head
    readout_hidden: int = 64
    param_dtype: str = "float32"

    def head_is_energy(self) -> bool:
        return self.n_classes == 0


# ---------------------------------------------------------------------------
# Radial / angular basis
# ---------------------------------------------------------------------------


def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Bessel radial basis with smooth polynomial cutoff (MACE eq. 7)."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    # the reference takes the square root in the array's type
    amp = torch.sqrt(torch.tensor(2.0 / r_cut, dtype=r.dtype, device=r.device))
    basis = amp * torch.sin(n * math.pi * r[..., None] / r_cut) / r[..., None]
    # polynomial cutoff envelope (p=6)
    u = torch.clamp(r / r_cut, 0.0, 1.0)
    env = 1.0 - 28.0 * u ** 6 + 48.0 * u ** 7 - 21.0 * u ** 8
    return basis * env[..., None]


def safe_norm(vec: torch.Tensor) -> torch.Tensor:
    """Norm with a defined (zero) gradient at vec = 0 (self-loop edges)."""
    sq = torch.sum(vec * vec, dim=-1)
    return torch.sqrt(torch.clamp(sq, min=1e-12))


def edge_harmonics(vec: torch.Tensor) -> tuple:
    """Cartesian 'spherical harmonics' of edge directions up to l=2:
    (Y1 (E, 3) unit vector, Y2 (E, 3, 3) traceless symmetric outer
    product)."""
    r = safe_norm(vec)[..., None]
    u = vec / torch.clamp(r, min=1e-6)
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device)
    y2 = u[..., :, None] * u[..., None, :] - eye / 3.0
    return u, y2


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _n_basis(correlation: int) -> tuple:
    """How many B-basis features feed each output rank (ν <= correlation)."""
    # rank 0: [A0] + ν2:[A0², A1·A1, A2:A2] + ν3:[A0³, A0(A1·A1), A1·A2·A1]
    # rank 1: [A1] + ν2:[A0A1, A2·A1]       + ν3:[A0²A1, (A1·A1)A1, A0 A2·A1]
    # rank 2: [A2] + ν2:[A0A2, sym(A1⊗A1)]  + ν3:[A0²A2, A0 sym(A1⊗A1)]
    if correlation >= 3:
        return 7, 6, 5
    if correlation == 2:
        return 4, 3, 3
    return 1, 1, 1


def init_params(generator: torch.Generator, cfg: MACEConfig) -> Params:
    """The reference's parameter tree, drawn on the generator's device."""
    pd = getattr(torch, cfg.param_dtype)
    g = generator
    C, L = cfg.d_hidden, cfg.n_layers
    n_b0, n_b1, n_b2 = _n_basis(cfg.correlation)
    p: Params = {
        "species": common.embed_init(g, (cfg.n_species, C), pd, 0.5),
        # per-layer radial MLPs: rbf -> 3 * C edge weights (one set per rank)
        "radial_w1": common.dense_init(g, (L, cfg.n_rbf, 2 * C), pd),
        "radial_b1": common.zeros_init(g, (L, 2 * C), pd),
        "radial_w2": common.dense_init(g, (L, 2 * C, 3 * C), pd),
        # B-basis linear mixing back to C channels per rank
        "mix0": common.dense_init(g, (L, n_b0 * C, C), pd),
        "mix1": common.dense_init(g, (L, n_b1 * C, C), pd),
        "mix2": common.dense_init(g, (L, n_b2 * C, C), pd),
        # residual update (scalar channel)
        "upd0": common.dense_init(g, (L, C, C), pd),
        # per-layer scalar readouts
        "ro_w1": common.dense_init(g, (L, C, cfg.readout_hidden), pd),
        "ro_b1": common.zeros_init(g, (L, cfg.readout_hidden), pd),
        "ro_w2": common.dense_init(g, (L, cfg.readout_hidden, max(cfg.n_classes, 1)), pd),
    }
    if cfg.d_node_feat:
        p["featproj"] = common.dense_init(g, (cfg.d_node_feat, C), pd)
        p["pos_embed"] = common.dense_init(g, (cfg.d_node_feat, 3), pd)
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def param_pspecs(cfg: MACEConfig) -> Dict[str, tuple]:
    """Each parameter's spec (``models.sharding``): MACE's parameters are
    small (under 10⁶), so every one is replicated (data parallel only)."""
    specs = {
        "species": (None, None),
        "radial_w1": (None, None, None),
        "radial_b1": (None, None),
        "radial_w2": (None, None, None),
        "mix0": (None, None, None),
        "mix1": (None, None, None),
        "mix2": (None, None, None),
        "upd0": (None, None, None),
        "ro_w1": (None, None, None),
        "ro_b1": (None, None),
        "ro_w2": (None, None, None),
    }
    if cfg.d_node_feat:
        specs["featproj"] = (None, None)
        specs["pos_embed"] = (None, None)
    return specs


def _scalar_basis(a0: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor, correlation: int):
    """The rank-0 features of the ACE product basis, the only ones that reach
    a readout: a0 (N, C), a1 (N, 3, C), a2 (N, 3, 3, C) -> b0 (N, n_b0 * C)."""
    b0 = [a0]
    if correlation >= 2:
        dot11 = torch.einsum("nic,nic->nc", a1, a1)  # A1·A1
        dot22 = torch.einsum("nijc,nijc->nc", a2, a2)  # A2:A2
        b0 += [a0 * a0, dot11, dot22]
        if correlation >= 3:
            b0 += [
                a0 * a0 * a0,
                a0 * dot11,
                torch.einsum("nic,nijc,njc->nc", a1, a2, a1),  # A1·A2·A1
            ]
    return torch.cat(b0, dim=-1)


def _product_basis(a0: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor, correlation: int):
    """ACE product basis: channel-wise contractions of the A-features up to
    order ν.  a0 (N, C), a1 (N, 3, C), a2 (N, 3, 3, C) -> (b0, b1, b2)."""
    b1, b2 = [a1], [a2]
    if correlation >= 2:
        dot11 = torch.einsum("nic,nic->nc", a1, a1)  # A1·A1
        a2a1 = torch.einsum("nijc,njc->nic", a2, a1)  # A2·A1
        sym11 = torch.einsum("nic,njc->nijc", a1, a1)
        eye = torch.eye(3, dtype=a1.dtype, device=a1.device)
        trace = torch.diagonal(sym11, dim1=1, dim2=2).sum(-1)
        sym11 = sym11 - trace[:, None, None, :] * (eye[None, :, :, None] / 3.0)
        b1 += [a0[:, None, :] * a1, a2a1]
        b2 += [a0[:, None, None, :] * a2, sym11]
        if correlation >= 3:
            b1 += [
                (a0 * a0)[:, None, :] * a1,
                dot11[:, None, :] * a1,
                a0[:, None, :] * a2a1,
            ]
            b2 += [(a0 * a0)[:, None, None, :] * a2, a0[:, None, None, :] * sym11]
    return (_scalar_basis(a0, a1, a2, correlation), torch.cat(b1, dim=-1),
            torch.cat(b2, dim=-1))


def _segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    if isinstance(data, DTensor):  # edges split over ranks: a pending sum over them
        return sharding.index_add_rows(data, ids, n)
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add(0, ids, data)


def forward(
    params: Params,
    positions: torch.Tensor,  # (N, 3)
    species: torch.Tensor,  # (N,) int
    senders: torch.Tensor,  # (E,) int
    receivers: torch.Tensor,  # (E,) int
    cfg: MACEConfig,
    *,
    node_feat: Optional[torch.Tensor] = None,  # (N, d_node_feat) citation shapes
    node_mask: Optional[torch.Tensor] = None,  # (N,) bool — padding
    edge_mask: Optional[torch.Tensor] = None,  # (E,) bool — padding
) -> torch.Tensor:
    """Per-node readout: (N,) energies or (N, n_classes) logits."""
    N = positions.shape[0]
    C = cfg.d_hidden
    senders, receivers = senders.long(), receivers.long()

    h0 = params["species"][species.long()]  # (N, C)
    if cfg.d_node_feat and node_feat is not None:
        h0 = h0 + node_feat @ params["featproj"]
        positions = positions + node_feat @ params["pos_embed"]

    vec = positions[senders] - positions[receivers]  # (E, 3)
    r = safe_norm(vec)
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.r_cut)  # (E, n_rbf)
    y1, y2 = edge_harmonics(vec)

    # degree normalization (MACE's avg_num_neighbors, per node): the same
    # in every layer
    ones = torch.ones(receivers.shape, dtype=torch.float32, device=receivers.device)
    if edge_mask is not None:
        ones = torch.where(edge_mask, ones, 0.0)
    inv = torch.rsqrt(torch.clamp(_segment_sum(ones, receivers, N), min=1.0))

    out_sum = None
    for layer in range(cfg.n_layers):
        # -- radial weights (per-edge, per-rank, per-channel) -----------------
        z = F.silu(rbf @ params["radial_w1"][layer] + params["radial_b1"][layer])
        rw = z @ params["radial_w2"][layer]  # (E, 3C)
        if edge_mask is not None:
            # padding edges contribute zero messages (the radial MLP has a bias)
            rw = torch.where(edge_mask[:, None], rw, 0.0)
        r0, r1, r2 = rw[:, :C], rw[:, C:2 * C], rw[:, 2 * C:]

        # -- A-basis: aggregate rank-l messages -------------------------------
        hs = h0[senders]  # (E, C)
        m0 = r0 * hs
        m1 = r1[:, None, :] * y1[:, :, None] * hs[:, None, :]
        m2 = r2[:, None, None, :] * y2[:, :, :, None] * hs[:, None, None, :]
        a0 = _segment_sum(m0, receivers, N) * inv[:, None]
        a1 = _segment_sum(m1, receivers, N) * inv[:, None, None]
        a2 = _segment_sum(m2, receivers, N) * inv[:, None, None, None]

        # -- B-basis products (ν <= correlation) + linear mix ------------------
        b0 = _scalar_basis(a0, a1, a2, cfg.correlation)
        h0 = F.silu(h0 @ params["upd0"][layer] + b0 @ params["mix0"][layer])

        # -- per-layer readout (MACE reads out every layer) --------------------
        ro = F.silu(h0 @ params["ro_w1"][layer] + params["ro_b1"][layer])
        ro = ro @ params["ro_w2"][layer]  # (N, n_out)
        out_sum = ro if out_sum is None else out_sum + ro

    if node_mask is not None:
        out_sum = torch.where(node_mask[:, None], out_sum, 0.0)
    if cfg.head_is_energy():
        return out_sum[:, 0]  # (N,) per-atom energies
    return out_sum  # (N, n_classes) logits


def energy(params, positions, species, senders, receivers, cfg, **kw) -> torch.Tensor:
    """Total energy of one structure (sum of per-atom contributions)."""
    return torch.sum(forward(params, positions, species, senders, receivers, cfg, **kw))


def forces(params, positions, species, senders, receivers, cfg, **kw) -> torch.Tensor:
    """F = -dE/dpos, the quantity MD users of MACE consume."""
    with torch.enable_grad():
        pos = positions.detach().requires_grad_(True)
        e = energy(params, pos, species, senders, receivers, cfg, **kw)
        (grad,) = torch.autograd.grad(e, pos)
    return -grad


# ---------------------------------------------------------------------------
# Losses (per data regime)
# ---------------------------------------------------------------------------


def node_class_loss(params, batch: Dict[str, Any], cfg: MACEConfig):
    """Full-graph / sampled node classification (cora / reddit / products)."""
    logits = forward(
        params, batch["positions"], batch["species"], batch["senders"], batch["receivers"], cfg,
        node_feat=batch.get("node_feat"), node_mask=batch.get("node_mask"),
        edge_mask=batch.get("edge_mask"),
    )
    labels = batch["labels"]
    train_mask = batch.get("train_mask")
    if train_mask is not None:
        labels = torch.where(train_mask, labels, -1)  # masked xent
    loss = common.softmax_xent(logits, labels)
    hit = (torch.argmax(logits, -1) == labels).to(logits.dtype)
    acc = torch.mean(torch.where(labels >= 0, hit, 0.0))
    return loss, {"acc": acc}


def energy_loss(params, batch: Dict[str, Any], cfg: MACEConfig):
    """Batched molecules: MSE on total energy.  The reference vmaps one
    molecule at a time; here the B molecules are one disjoint graph (node
    ids offset by b·N), so each molecule's energy is the same function of
    its own atoms and edges."""
    pos, spec = batch["positions"], batch["species"]  # (B, N, 3), (B, N)
    B, N = spec.shape
    offs = (torch.arange(B, device=spec.device) * N)[:, None]
    snd = (batch["senders"].long() + offs).reshape(-1)
    rcv = (batch["receivers"].long() + offs).reshape(-1)
    per_atom = forward(params, pos.reshape(B * N, 3), spec.reshape(-1), snd, rcv, cfg)
    e = per_atom.reshape(B, N).sum(dim=1)
    loss = torch.mean((e - batch["energy"]) ** 2)
    return loss, {"rmse": torch.sqrt(loss)}
