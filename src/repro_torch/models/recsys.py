"""The four recommender architectures (counterpart of ``repro.models.recsys``).

* **deepfm**  (arXiv:1703.04247): FM first and second order over 39 field
  embeddings (dim 10) beside a deep MLP 400-400-400, summed logits.
* **xdeepfm** (arXiv:1803.05170): CIN 200-200-200 (compressed interaction
  network) beside an MLP 400-400.
* **bst**     (arXiv:1905.06874): behaviour-sequence transformer, one block
  of 8 heads over the 20-item history and the target, MLP 1024-512-256.
* **mind**    (arXiv:1904.08030): multi-interest capsule routing (4
  interests, 3 routing iterations) and label-aware attention; its serving
  path is candidate retrieval, where the LGD graph is the index
  (``serve.retrieval``).

Plain functions on a parameter dict, each named as its reference
counterpart.  Entry points that score many rows (``serve_scores``,
``ctr_retrieval_scores``, ``bst_retrieval_scores``, and ``cin``) work in row
chunks: at full width the reference's one-shot contraction would hold
xDeepFM's (B, H, F, D) product (82 GB at serve_bulk) or BST's attention over
10^6 candidates (14 GB).  A row's score depends on no other row, and every
product inside keeps at least two rows, so the chunked scores equal the
whole batch's bit for bit on the CPU.  ``loss_fn`` runs its batch whole:
under autograd every chunk's graph is kept for the backward pass, so chunks
save no memory there; training bounds memory with gradient accumulation
(``train.train_loop.make_train_step(accum_steps=...)``).

MIND's routing logits are a fixed random draw in the reference
(``PRNGKey(7)``, one per history length); here ``routing_init(S, K)`` makes
them, by default a normal draw from a CPU generator seeded 7, the same on
every device.  The tests replay the reference's draw through it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import common, embedding, sharding

Params = Dict[str, object]
RoutingInit = Callable[[int, int], torch.Tensor]

#: elements of the largest intermediate one row chunk may hold (512 MB fp32)
ROW_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "deepfm"  # deepfm | xdeepfm | bst | mind
    n_sparse: int = 39
    n_dense: int = 13
    vocab_per_field: int = 1_000_000
    embed_dim: int = 10
    mlp: Tuple[int, ...] = (400, 400, 400)
    # xdeepfm
    cin_layers: Tuple[int, ...] = ()
    # bst
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    # mind
    n_interests: int = 4
    capsule_iters: int = 3
    param_dtype: str = "float32"

    @property
    def total_rows(self) -> int:
        return self.n_sparse * self.vocab_per_field

    def table(self) -> embedding.TableConfig:
        return embedding.TableConfig(rows=self.total_rows, dim=self.embed_dim)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: RecsysConfig) -> Params:
    """The reference's parameter tree, drawn in a fixed order from one
    generator on its device (the numbers differ from the reference's: the
    tests carry its parameters across with ``convert``)."""
    pd = getattr(torch, cfg.param_dtype)
    g = generator
    p: Params = {}
    D = cfg.embed_dim

    if cfg.name in ("deepfm", "xdeepfm"):
        p["table"] = embedding.init_table(g, cfg.table(), pd)
        p["lin_table"] = embedding.init_table(
            g, embedding.TableConfig(rows=cfg.total_rows, dim=1), pd)
        p["dense_proj"] = common.dense_init(g, (cfg.n_dense, cfg.n_sparse * D), pd)
        p["mlp"] = common.mlp_stack(g, [cfg.n_sparse * D, *cfg.mlp, 1], pd)
        if cfg.name == "xdeepfm":
            widths = [cfg.n_sparse, *cfg.cin_layers]
            p["cin"] = {
                f"w{i}": common.dense_init(g, (hout, hin, cfg.n_sparse), pd,
                                           scale=math.sqrt(hin * cfg.n_sparse) / math.sqrt(hin))
                for i, (hin, hout) in enumerate(zip(widths[:-1], widths[1:]))
            }
            p["cin_out"] = common.dense_init(g, (sum(cfg.cin_layers), 1), pd)
    elif cfg.name == "bst":
        p["table"] = embedding.init_table(
            g, embedding.TableConfig(rows=cfg.vocab_per_field, dim=D), pd)
        p["pos"] = common.embed_init(g, (cfg.seq_len + 1, D), pd, 0.02)
        nb = cfg.n_blocks
        p["attn"] = {
            **{w: common.dense_init(g, (nb, D, D), pd) for w in ("wq", "wk", "wv", "wo")},
            "ff1": common.dense_init(g, (nb, D, 4 * D), pd),
            "ff2": common.dense_init(g, (nb, 4 * D, D), pd),
            "ln1": common.zeros_init(g, (nb, D), pd),
            "ln2": common.zeros_init(g, (nb, D), pd),
        }
        p["mlp"] = common.mlp_stack(g, [(cfg.seq_len + 1) * D, *cfg.mlp, 1], pd)
    elif cfg.name == "mind":
        p["table"] = embedding.init_table(
            g, embedding.TableConfig(rows=cfg.vocab_per_field, dim=D), pd)
        p["caps_bilinear"] = common.dense_init(g, (D, D), pd)
        p["mlp"] = common.mlp_stack(g, [D, *cfg.mlp, D], pd)
    else:
        raise ValueError(cfg.name)
    return p


def param_pspecs(cfg: RecsysConfig) -> Dict:
    """Each parameter's spec (``models.sharding``): the embedding tables
    row-split over "model", everything else replicated.  The tree's layout
    comes from ``init_params`` of ``_tiny_like(cfg)``."""
    specs = _replicated(init_params(torch.Generator().manual_seed(0), _tiny_like(cfg)))
    for name in ("table", "lin_table"):
        if name in specs:
            specs[name] = ("model", None)
    return specs


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    return (None,) * tree.dim()


def _tiny_like(cfg: RecsysConfig) -> RecsysConfig:
    """The same parameter layout with tiny tables (spec derivation only)."""
    return dataclasses.replace(cfg, vocab_per_field=8)


# ---------------------------------------------------------------------------
# Row chunks
# ---------------------------------------------------------------------------


def row_slices(n: int, chunk: int) -> list:
    """Slices of ``chunk`` rows over n rows.  No slice holds a single row
    unless n is 1: a one-row product takes BLAS's vector path, which rounds
    differently, so a chunk keeps at least two rows and a last single row
    joins the slice before it."""
    chunk = max(int(chunk), 2)
    starts = list(range(0, n, chunk)) or [0]
    if len(starts) > 1 and n - starts[-1] == 1:
        starts.pop()
    return [slice(a, b) for a, b in zip(starts, starts[1:] + [n])]


def _by_rows(fn, chunk: int, *tensors: torch.Tensor) -> torch.Tensor:
    """fn over row slices of ``tensors``, concatenated; rows split over a
    mesh (DTensors) are sliced on each rank, over its own rows."""
    if sharding.row_split(tensors[0]):
        return sharding.map_rank_rows(lambda *ts: _by_rows(fn, chunk, *ts), *tensors)
    slices = row_slices(tensors[0].shape[0], chunk)
    if len(slices) == 1:
        return fn(*tensors)
    return torch.cat([fn(*(t[s] for t in tensors)) for s in slices])


def default_chunk(cfg: RecsysConfig) -> int:
    """Rows per chunk whose largest intermediate stays near ``ROW_ELEMS``
    elements: xDeepFM's CIN product (H·F·D a row), BST's attention scores
    and FF hidden, the embeddings and MLP widths of the others."""
    F, D, S1 = cfg.n_sparse, cfg.embed_dim, cfg.seq_len + 1
    if cfg.name == "bst":
        per_row = S1 * max(cfg.n_heads * S1, 4 * D)
    elif cfg.name == "mind":
        per_row = cfg.seq_len * max(D, cfg.n_interests)
    elif cfg.cin_layers:
        per_row = _cin_row_elems(F, D, cfg.cin_layers)
    else:
        per_row = F * D
    return max(2, ROW_ELEMS // max(per_row, *cfg.mlp))


# ---------------------------------------------------------------------------
# Interaction blocks
# ---------------------------------------------------------------------------


def fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """(B, F, D) -> (B,): ½[(Σ_f v)² − Σ_f v²] summed over D."""
    s = emb.sum(dim=1)
    s2 = (emb * emb).sum(dim=1)
    return 0.5 * (s * s - s2).sum(dim=-1)


def _cin_row_elems(F: int, D: int, widths: Tuple[int, ...]) -> int:
    """Elements of the CIN's outer product for one row: H·F·D, H its
    widest input layer."""
    return F * D * max((F,) + tuple(widths[:-1]))


def _cin_rows(x0: torch.Tensor, params: Dict[str, torch.Tensor], n_layers: int) -> torch.Tensor:
    b, F, D = x0.shape
    # layout (b, D, h): each layer's outer product is one (b·D, h·F) matrix
    x0t = x0.transpose(1, 2)
    xt = x0t
    pools = []
    for i in range(n_layers):
        w = params[f"w{i}"]  # (hout, hin, F)
        z = (xt[..., :, None] * x0t[..., None, :]).reshape(b * D, -1)
        xt = (z @ w.reshape(w.shape[0], -1).T).reshape(b, D, -1)
        pools.append(xt.sum(dim=1))  # sum-pool over D -> (b, hout)
    return torch.cat(pools, dim=-1)


def cin(emb: torch.Tensor, params: Dict[str, torch.Tensor], widths: Tuple[int, ...],
        chunk: Optional[int] = None) -> torch.Tensor:
    """Compressed Interaction Network: (B, F, D) -> (B, sum(widths)),
    x^k_h = Σ_{i,j} W^k_{h i j} (x^{k-1}_i ∘ x^0_j), sum-pooled over D.

    The reference contracts ``"bhd,bfd,ohf->bod"`` in one einsum; torch
    builds the (B, H, F, D) product on the way, so this works in chunks of
    ``chunk`` rows (default: the product near ``ROW_ELEMS`` elements)."""
    B, F, D = emb.shape
    if chunk is None:
        chunk = ROW_ELEMS // _cin_row_elems(F, D, widths)
    return _by_rows(lambda e: _cin_rows(e, params, len(widths)), chunk, emb)


def _bst_block(h: torch.Tensor, bp: Dict[str, torch.Tensor], i: int,
               n_heads: int) -> torch.Tensor:
    """One post-LN transformer block over the (B, S+1, D) behaviour sequence."""
    B, S, D = h.shape
    dh = D // n_heads
    q = (h @ bp["wq"][i]).reshape(B, S, n_heads, dh)
    k = (h @ bp["wk"][i]).reshape(B, S, n_heads, dh)
    v = (h @ bp["wv"][i]).reshape(B, S, n_heads, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    att = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, S, D)
    ln1, ln2 = bp["ln1"][i], bp["ln2"][i]
    h = common.layer_norm(h + o @ bp["wo"][i], 1.0 + ln1, torch.zeros_like(ln1))
    f = torch.relu(h @ bp["ff1"][i]) @ bp["ff2"][i]
    return common.layer_norm(h + f, 1.0 + ln2, torch.zeros_like(ln2))


def default_routing_init(S: int, K: int) -> torch.Tensor:
    """MIND's fixed (untrainable) routing logits for histories of length S:
    N(0, 1) from a CPU generator seeded 7, so every device gets the same."""
    return torch.randn((S, K), generator=torch.Generator().manual_seed(7))


def capsule_routing(
    hist_emb: torch.Tensor,  # (B, S, D) behaviour capsules (zeros at padding)
    hist_mask: torch.Tensor,  # (B, S)
    bilinear: torch.Tensor,  # (D, D)
    n_interests: int,
    iters: int,
    routing_init: Optional[RoutingInit] = None,
) -> torch.Tensor:
    """MIND's B2I dynamic routing -> (B, K, D) interest capsules."""
    B, S, D = hist_emb.shape
    u = hist_emb @ bilinear  # (B, S, D) behaviour->interest projections
    b0 = (routing_init or default_routing_init)(S, n_interests)
    # shared across the batch (MIND §4.2)
    b = b0.to(device=u.device, dtype=u.dtype)[None].expand(B, S, n_interests)

    def squash(z):
        n2 = (z * z).sum(dim=-1, keepdim=True)
        return (n2 / (1.0 + n2)) * z / torch.sqrt(n2.clamp(min=1e-9))

    caps = None
    for _ in range(iters):
        w = torch.softmax(b, dim=-1)  # routing over interests
        w = torch.where(hist_mask[..., None], w, 0.0)
        caps = squash(torch.einsum("bsk,bsd->bkd", w, u))  # (B, K, D)
        b = b + torch.einsum("bsd,bkd->bsk", u, caps)
    return caps


# ---------------------------------------------------------------------------
# Forward / losses
# ---------------------------------------------------------------------------


def field_ids(sparse: torch.Tensor, cfg: RecsysConfig) -> torch.Tensor:
    """Per-field ids offset into the one shared table, in int64."""
    offs = torch.arange(cfg.n_sparse, device=sparse.device, dtype=torch.int64)
    return sparse.long() + offs[None, :] * cfg.vocab_per_field


def _ctr_head(params: Params, emb: torch.Tensor, first: torch.Tensor, deep_in: torch.Tensor,
              cfg: RecsysConfig) -> torch.Tensor:
    deep = common.mlp_apply(params["mlp"], deep_in, act="relu")[:, 0]
    if cfg.name == "deepfm":
        return first + fm_second_order(emb) + deep
    # whole rows here: the scorers chunk the rows they meet, and under
    # autograd a chunk saves nothing (its graph is kept for the backward pass)
    feats = cin(emb, params["cin"], cfg.cin_layers, chunk=emb.shape[0])
    return first + common.linear(feats, params["cin_out"])[:, 0] + deep


def ctr_logits(params: Params, batch: Dict[str, torch.Tensor], cfg: RecsysConfig) -> torch.Tensor:
    """deepfm / xdeepfm pointwise CTR score."""
    F, D = cfg.n_sparse, cfg.embed_dim
    ids = field_ids(batch["sparse"], cfg)
    emb = embedding.lookup(params["table"], ids)  # (B, F, D)
    lin = embedding.lookup(params["lin_table"], ids)[..., 0]  # (B, F)
    first = lin.sum(dim=1)
    deep_in = emb.reshape(emb.shape[0], F * D) + batch["dense"] @ params["dense_proj"]
    return _ctr_head(params, emb, first, deep_in, cfg)


def bst_logits(params: Params, batch: Dict[str, torch.Tensor], cfg: RecsysConfig) -> torch.Tensor:
    seq = torch.cat([batch["hist"], batch["target"][:, None]], dim=1)  # (B, S+1)
    h = embedding.lookup(params["table"], seq) + params["pos"][None]
    for i in range(cfg.n_blocks):
        h = _bst_block(h, params["attn"], i, cfg.n_heads)
    return common.mlp_apply(params["mlp"], h.reshape(h.shape[0], -1), act="relu")[:, 0]


def mind_interests(params: Params, hist: torch.Tensor, cfg: RecsysConfig,
                   routing_init: Optional[RoutingInit] = None) -> torch.Tensor:
    """User history -> (B, K, D) interest vectors (the serving-side encoder)."""
    emb = embedding.lookup(params["table"], hist)
    caps = capsule_routing(emb, hist >= 0, params["caps_bilinear"], cfg.n_interests,
                           cfg.capsule_iters, routing_init)
    B, K, D = caps.shape
    out = common.mlp_apply(params["mlp"], caps.reshape(B * K, D), act="relu")
    return out.reshape(B, K, D)


def mind_logits(params: Params, batch: Dict[str, torch.Tensor], cfg: RecsysConfig,
                routing_init: Optional[RoutingInit] = None) -> torch.Tensor:
    """Label-aware attention (pow=2) over the interests against the target."""
    interests = mind_interests(params, batch["hist"], cfg, routing_init)  # (B, K, D)
    t = embedding.lookup(params["table"], batch["target"])  # (B, D)
    scores = torch.einsum("bkd,bd->bk", interests, t)
    att = torch.softmax(scores * 2.0, dim=-1)  # label-aware attention
    user = torch.einsum("bk,bkd->bd", att, interests)
    return (user * t).sum(dim=-1)


def _logits(params: Params, batch: Dict[str, torch.Tensor], cfg: RecsysConfig,
            routing_init: Optional[RoutingInit]) -> torch.Tensor:
    if cfg.name in ("deepfm", "xdeepfm"):
        return ctr_logits(params, batch, cfg)
    if cfg.name == "bst":
        return bst_logits(params, batch, cfg)
    return mind_logits(params, batch, cfg, routing_init)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: RecsysConfig,
            routing_init: Optional[RoutingInit] = None):
    """(sigmoid BCE loss, {"acc": accuracy}) of one batch, forward only."""
    logits = _logits(params, batch, cfg, routing_init)
    loss = common.sigmoid_bce(logits, batch["label"])
    acc = ((logits > 0) == (batch["label"] > 0.5)).float().mean()
    return loss, {"acc": acc}


def serve_scores(params: Params, batch: Dict[str, torch.Tensor], cfg: RecsysConfig, *,
                 chunk: Optional[int] = None,
                 routing_init: Optional[RoutingInit] = None) -> torch.Tensor:
    """Pointwise inference (the serve_p99 / serve_bulk shapes), in chunks of
    ``chunk`` rows (default ``default_chunk(cfg)``)."""
    names = [k for k in ("dense", "sparse", "hist", "target") if k in batch]

    def rows(*ts):
        return torch.sigmoid(_logits(params, dict(zip(names, ts)), cfg, routing_init))

    return _by_rows(rows, chunk or default_chunk(cfg), *(batch[k] for k in names))


def retrieval_scores(params: Params, hist: torch.Tensor, candidates: torch.Tensor,
                     cfg: RecsysConfig,
                     routing_init: Optional[RoutingInit] = None) -> torch.Tensor:
    """retrieval_cand: one user's interests against N candidate embeddings,
    a (N, D) x (D, K) product and the max over interests -> (N,) scores.
    The ANN path over the same candidates is ``serve.retrieval`` with
    ``metric="ip"``."""
    interests = mind_interests(params, hist, cfg, routing_init)[0]  # (K, D)
    return (candidates @ interests.T).max(dim=-1).values


def ctr_retrieval_scores(params: Params, batch: Dict[str, torch.Tensor], cfg: RecsysConfig, *,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """deepfm/xdeepfm retrieval_cand: one user context against N candidate
    items for field 0.  The user's rows are gathered once; each chunk of
    candidates writes its item into field 0 of a copy (the reference's
    ``.at[:, 0, :].set`` on a broadcast) and runs the whole model.
    batch: dense (1, n_dense), sparse (1, F), cand (N,)."""
    F, D = cfg.n_sparse, cfg.embed_dim
    ids = field_ids(batch["sparse"], cfg)
    user_emb = embedding.lookup(params["table"], ids)  # (1, F, D)
    user_lin = embedding.lookup(params["lin_table"], ids)[..., 0]  # (1, F)
    user_first = user_lin[0, 1:].sum()
    dense_term = batch["dense"] @ params["dense_proj"]  # (1, F*D)

    def rows(cand):
        n = cand.shape[0]
        cand_emb = embedding.lookup(params["table"], cand)  # (n, D) field 0
        cand_lin = embedding.lookup(params["lin_table"], cand)[..., 0]  # (n,)
        emb = torch.cat([cand_emb[:, None, :], user_emb[:, 1:, :].expand(n, F - 1, D)], dim=1)
        deep_in = emb.reshape(n, F * D) + dense_term
        return _ctr_head(params, emb, user_first + cand_lin, deep_in, cfg)

    return _by_rows(rows, chunk or default_chunk(cfg), batch["cand"])


def bst_retrieval_scores(params: Params, batch: Dict[str, torch.Tensor], cfg: RecsysConfig, *,
                         chunk: Optional[int] = None) -> torch.Tensor:
    """bst retrieval_cand: one history against N candidate targets.  The
    candidate sits in the sequence, so the block runs per candidate on
    (N, S+1, D), in chunks of ``chunk`` candidates; the history's rows are
    gathered once.  batch: hist (1, S), cand (N,)."""
    S, D = cfg.seq_len, cfg.embed_dim
    h_hist = embedding.lookup(params["table"], batch["hist"])  # (1, S, D)

    def rows(cand):
        n = cand.shape[0]
        h_cand = embedding.lookup(params["table"], cand)[:, None, :]  # (n, 1, D)
        h = torch.cat([h_hist.expand(n, S, D), h_cand], dim=1) + params["pos"][None]
        for i in range(cfg.n_blocks):
            h = _bst_block(h, params["attn"], i, cfg.n_heads)
        return common.mlp_apply(params["mlp"], h.reshape(n, -1), act="relu")[:, 0]

    return _by_rows(rows, chunk or default_chunk(cfg), batch["cand"])
