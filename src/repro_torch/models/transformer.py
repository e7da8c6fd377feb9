"""Config-driven decoder-only LM covering the five LM archs (counterpart of
``repro.models.transformer``).

One parameterization spans mixtral-8x7b (GQA kv=8, SWA 4096, MoE 8e top-2),
arctic-480b (GQA kv=8, MoE 128e top-2 + parallel dense residual FFN),
stablelm-1.6b (kv=32), qwen2.5-3b (GQA kv=2, QKV bias) and gemma3-1b (GQA
kv=1, head_dim 256, 5:1 local:global attention).

Parameters are stacked (L, ...) tensors in a plain dict, as the reference
stores them; its ``lax.scan`` over layers is a Python loop over layer
slices.  ``remat`` wraps each layer in ``torch.utils.checkpoint`` (when a
gradient is being taken), so only layer-boundary activations are kept.
Activations are computed in ``compute_dtype`` (bf16 by default), parameters
stored in ``param_dtype``; softmaxes and the loss run in fp32.

Placement follows the reference: ``param_pspecs`` gives each parameter's
spec on the production meshes (Megatron tensor parallelism, expert
parallelism at 16 experts or more), and the forward calls
``sharding.constrain`` at the reference's sites, with the ZeRO-3 use
constraints of ``_use_constrain_layer`` under ``zero3_use_constraints`` and
sequence-sharded layer boundaries under ``seq_shard``.  Off a mesh, and on
plain tensors, every constraint is the identity.

Decode caches are written in place: ``decode_step`` and
``decode_step_split`` store the new token's K/V into the cache tensors they
are given and return the same tensors with ``len`` advanced, where the
reference returns new arrays (an eager stack of per-layer caches would copy
the whole cache every token).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_lib
from repro_torch.models import attention, common
from repro_torch.models import moe as moe_lib
from repro_torch.models import sharding
from repro_torch.models.sharding import constrain
from repro_torch.models.attention import ring_decode_attention  # noqa: F401  (the reference's home)

FULL_WINDOW = 1 << 30  # "no window": i - j < 2^30 is always true in-range


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    d_head: Optional[int] = None  # default d_model // n_heads (gemma3: 256)
    act: str = "silu"
    qkv_bias: bool = False  # qwen2.5
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    # attention pattern
    window: Optional[int] = None  # sliding window (mixtral 4096); None = full
    local_global: Optional[Tuple[int, int]] = None  # gemma3: (5 local, 1 global)
    local_window: int = 1024
    # MoE
    moe: Optional[moe_lib.MoEConfig] = None
    moe_d_ff: int = 0  # expert hidden width (falls back to d_ff)
    dense_residual: bool = False  # arctic: parallel dense FFN
    dense_d_ff: int = 0
    moe_groups: int = 1  # dispatch groups (per-group capacity)
    # numerics / scheduling
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 512
    # the statically tiled attention schedule (``tiled_causal_attention``)
    unrolled: bool = False
    # placement: ZeRO-3 weight use constraints and sequence-sharded layer
    # boundaries, both on the statically unrolled schedule (off a mesh,
    # constraints are the identity)
    zero3_use_constraints: bool = False
    seq_shard: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    def window_by_layer(self) -> np.ndarray:
        """Static (L,) per-layer attention window."""
        L = self.n_layers
        if self.local_global is not None:
            nl, ng = self.local_global
            period = nl + ng
            pat = [self.local_window] * nl + [FULL_WINDOW] * ng
            return np.asarray([pat[i % period] for i in range(L)], np.int32)
        if self.window is not None:
            return np.full((L,), self.window, np.int32)
        return np.full((L,), FULL_WINDOW, np.int32)

    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = self.n_layers * (
            d * (self.n_heads * dh)
            + 2 * d * (self.n_kv_heads * dh)
            + (self.n_heads * dh) * d
        )
        if self.moe is not None:
            f = self.moe_d_ff or self.d_ff
            ffn = self.n_layers * self.moe.n_experts * 3 * d * f
            ffn += self.n_layers * d * self.moe.n_experts
            if self.dense_residual:
                ffn += self.n_layers * 3 * d * (self.dense_d_ff or self.d_ff)
        else:
            ffn = self.n_layers * 3 * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return attn + ffn + emb + self.n_layers * 2 * d + d

    def active_param_count(self) -> int:
        """6·N_active·D counting for MoE rooflines."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        f = self.moe_d_ff or self.d_ff
        total = self.param_count()
        all_exp = self.n_layers * self.moe.n_experts * 3 * d * f
        act_exp = self.n_layers * self.moe.top_k * 3 * d * f
        return total - all_exp + act_exp


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _dense(g: torch.Generator, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """``common.dense_init`` of a stacked leaf, one (rows, cols) matrix at a
    time (the fan-in is the same): the fp32 draws of a whole arctic expert
    stack would take 18 GB of transient memory per leaf."""
    if len(shape) <= 2:
        return common.dense_init(g, shape, dtype)
    out = torch.empty(shape, dtype=dtype, device=g.device)
    for i in range(shape[0]):
        out[i] = _dense(g, shape[1:], dtype)
    return out


def param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """name -> (shape, dtype) of the reference's parameter leaves for
    ``cfg``, in ``init_params``'s draw order."""
    pd = _dtype(cfg.param_dtype)
    d, dh, H, KV, L = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    p = {
        "embed": ((cfg.vocab, d), pd),
        "ln1": ((L, d), pd),
        "ln2": ((L, d), pd),
        "ln_f": ((d,), pd),
        "wq": ((L, d, H * dh), pd),
        "wk": ((L, d, KV * dh), pd),
        "wv": ((L, d, KV * dh), pd),
        "wo": ((L, H * dh, d), pd),
    }
    if cfg.qkv_bias:
        p.update(bq=((L, H * dh), pd), bk=((L, KV * dh), pd), bv=((L, KV * dh), pd))
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        f = cfg.moe_d_ff or cfg.d_ff
        p.update(router=((L, d, E), torch.float32), w_gate=((L, E, d, f), pd),
                 w_up=((L, E, d, f), pd), w_down=((L, E, f, d), pd))
        if cfg.dense_residual:
            df = cfg.dense_d_ff or cfg.d_ff
            p.update(dense_gate=((L, d, df), pd), dense_up=((L, d, df), pd),
                     dense_down=((L, df, d), pd))
    else:
        p.update(w_gate=((L, d, cfg.d_ff), pd), w_up=((L, d, cfg.d_ff), pd),
                 w_down=((L, cfg.d_ff, d), pd))
    if not cfg.tie_embeddings:
        p["head"] = ((d, cfg.vocab), pd)
    return p


_ZERO_INIT = ("ln1", "ln2", "ln_f", "bq", "bk", "bv")


def init_params(generator: torch.Generator, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """The reference's parameter dict, drawn in a fixed order from one
    generator on its device (the numbers differ from the reference's: the
    tests carry its parameters across with ``convert``): the embedding
    N(0, 1), norms and biases zero, every other leaf ``dense_init``."""
    g = generator
    p = {}
    for name, (shape, dt) in param_shapes(cfg).items():
        if name == "embed":
            p[name] = common.embed_init(g, shape, dt)
        elif name in _ZERO_INIT:
            p[name] = torch.zeros(shape, dtype=dt, device=g.device)
        else:
            p[name] = _dense(g, shape, dt)
    return p


def param_pspecs(cfg: TransformerConfig, fsdp: bool = False) -> Dict[str, tuple]:
    """Each parameter's spec (``models.sharding``): Megatron tensor
    parallelism over "model", with ``fsdp`` the d_model axis of the big
    matrices over "data"; MoE experts split over "model" at 16 experts or
    more (expert parallelism), else each expert tensor-parallel."""
    dp = "data" if fsdp else None
    specs: Dict[str, tuple] = {
        "embed": ("model", None),
        "ln1": (None, None),
        "ln2": (None, None),
        "ln_f": (None,),
        "wq": (None, dp, "model"),
        "wk": (None, dp, "model"),
        "wv": (None, dp, "model"),
        "wo": (None, "model", dp),
    }
    if cfg.qkv_bias:
        specs.update(bq=(None, "model"), bk=(None, "model"), bv=(None, "model"))
    if cfg.moe is not None:
        specs["router"] = (None, None, None)
        if cfg.moe.n_experts >= 16:  # expert parallelism (arctic: 128 / 16 per chip)
            specs.update(w_gate=(None, "model", dp, None), w_up=(None, "model", dp, None),
                         w_down=(None, "model", None, dp))
        else:  # per-expert tensor parallelism (mixtral: 8 experts < 16 chips)
            specs.update(w_gate=(None, None, dp, "model"), w_up=(None, None, dp, "model"),
                         w_down=(None, None, "model", dp))
        if cfg.dense_residual:
            specs.update(dense_gate=(None, dp, "model"), dense_up=(None, dp, "model"),
                         dense_down=(None, "model", dp))
    else:
        specs.update(w_gate=(None, dp, "model"), w_up=(None, dp, "model"),
                     w_down=(None, "model", dp))
    if not cfg.tie_embeddings:
        specs["head"] = (None, "model")
    return specs


# ---------------------------------------------------------------------------
# Layer pieces shared by forward, prefill and the two decode steps
# ---------------------------------------------------------------------------

_LAYER_KEYS = (
    "ln1", "ln2", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
    "router", "w_gate", "w_up", "w_down", "dense_gate", "dense_up", "dense_down",
)
_MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def _split_layer_params(params):
    layer = {k: v for k, v in params.items() if k in _LAYER_KEYS}
    rest = {k: v for k, v in params.items() if k not in _LAYER_KEYS}
    return layer, rest


def _layer_slice(layer_params, li: int) -> Dict[str, torch.Tensor]:
    return {k: v[li] for k, v in layer_params.items()}


def _use_constrain_layer(lp: Dict[str, torch.Tensor], cfg: TransformerConfig):
    """ZeRO-3 made explicit, under ``zero3_use_constraints``: each weight of
    one layer constrained to its use sharding (replicated over "data",
    split over "model"), so a data-sharded weight is gathered once per use
    instead of its activation being reduced."""
    if not cfg.zero3_use_constraints:
        return lp
    specs = {
        "wq": (None, "model"), "wk": (None, "model"), "wv": (None, "model"),
        "wo": ("model", None),
        "dense_gate": (None, "model"), "dense_up": (None, "model"),
        "dense_down": ("model", None),
    }
    if cfg.moe is not None and cfg.moe.n_experts >= 16:  # expert parallelism
        specs.update(w_gate=("model", None, None), w_up=("model", None, None),
                     w_down=("model", None, None))
    elif cfg.moe is not None:  # per-expert tensor parallelism
        specs.update(w_gate=(None, None, "model"), w_up=(None, None, "model"),
                     w_down=(None, "model", None))
    else:
        specs.update(w_gate=(None, "model"), w_up=(None, "model"), w_down=("model", None))
    return {k: constrain(v, *specs[k]) if k in specs else v for k, v in lp.items()}


def _unrolled_slice(layer_params, li: int, cfg: TransformerConfig):
    """Layer li's weights; the reference's statically unrolled schedule
    also constrains them to their use sharding."""
    lp = _layer_slice(layer_params, li)
    return _use_constrain_layer(lp, cfg) if cfg.unrolled else lp


def _embed(rest, tokens: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """Token embeddings times sqrt(d_model) rounded to the compute dtype
    (at bf16, sqrt(1152) is 34.0)."""
    cd = _dtype(cfg.compute_dtype)
    emb = rest["embed"]
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=cd, device=emb.device)
    if sharding.row_split(emb):  # the vocabulary split over ranks
        return sharding.gather_rows(emb, tokens.long()).to(cd) * scale
    return emb[tokens.long()].to(cd) * scale


def _rope(positions: torch.Tensor, cfg: TransformerConfig) -> tuple:
    """The RoPE tables of ``positions`` (B, S), shared by every layer."""
    return attention.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _qkv(a: torch.Tensor, lp, cfg: TransformerConfig, rope: tuple):
    """Normed activations (B, S, d) -> RoPE'd q (B, S, H, dh), k and v
    (B, S, KV, dh); ``rope`` is the positions' ``attention.rope_tables``."""
    cd = a.dtype
    B, S, _ = a.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = a @ lp["wq"].to(cd)
    k = a @ lp["wk"].to(cd)
    v = a @ lp["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cd)
        k = k + lp["bk"].to(cd)
        v = v + lp["bv"].to(cd)
    q = attention.apply_rope(q.reshape(B, S, H, dh), rope)
    k = attention.apply_rope(k.reshape(B, S, KV, dh), rope)
    return q, k, v.reshape(B, S, KV, dh)


def _identity(x, *spec):
    return x


def _ffn(m: torch.Tensor, lp, cfg: TransformerConfig, act: str, hint=_identity):
    """The layer's FFN on normed activations (B, S, d): the dense SwiGLU, or
    the MoE (plus arctic's dense residual).  Returns (out, aux).  ``hint``
    places the dense intermediate (the forward's: ``constrain``)."""
    cd = m.dtype
    B, S, d = m.shape
    fn = common.ACTIVATIONS[cfg.act]
    aux: Dict[str, torch.Tensor] = {}
    if cfg.moe is not None:
        mo, aux = moe_lib.apply_moe({k: lp[k] for k in _MOE_KEYS}, m.reshape(B * S, d), cfg.moe,
                                    act=act, groups=cfg.moe_groups)
        out = mo.reshape(B, S, d)
        if cfg.dense_residual:
            dz = fn(m @ lp["dense_gate"].to(cd)) * (m @ lp["dense_up"].to(cd))
            out = out + dz @ lp["dense_down"].to(cd)
    else:
        z = fn(m @ lp["w_gate"].to(cd)) * (m @ lp["w_up"].to(cd))
        z = hint(z, "batch", None, "model")
        out = z @ lp["w_down"].to(cd)
    return out, aux


def _head(rest, cfg: TransformerConfig, dtype: torch.dtype) -> torch.Tensor:
    head = rest["head"] if not cfg.tie_embeddings else rest["embed"].T
    return head.to(dtype)


def _softcap(logits: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    if cfg.logit_softcap:
        return torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(cfg: TransformerConfig, hint=_identity):
    """One layer on (B, S, d) -> (h, MoE aux, k, v); prefill keeps k, v.
    ``hint`` places the activations: the forward passes ``constrain``;
    prefill has no activation constraints, as in the reference."""

    def body(h: torch.Tensor, lp: Dict[str, torch.Tensor], window: int, cos: torch.Tensor,
             sin: torch.Tensor):
        B, S, d = h.shape
        a = common.rms_norm(h, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(a, lp, cfg, (cos, sin))
        q = hint(q, "batch", None, "model", None)
        attn = attention.tiled_causal_attention if cfg.unrolled else \
            attention.chunked_causal_attention
        o = attn(q, k, v, window, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
        h = h + hint(o.reshape(B, S, -1) @ lp["wo"].to(h.dtype), "batch", None, None)
        m = common.rms_norm(h, lp["ln2"], cfg.norm_eps)
        out, aux = _ffn(m, lp, cfg, cfg.act, hint)
        return h + hint(out, "batch", None, None), aux, k, v

    return body


def _stack_aux(auxs) -> Dict[str, torch.Tensor]:
    """Per-layer aux dicts -> {name: (L,) tensor} ({} without MoE)."""
    if not auxs or not auxs[0]:
        return {}
    return {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}


def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens (B, S) -> (logits (B, S, vocab) in the compute dtype, aux)."""
    B, S = tokens.shape
    layer_params, rest = _split_layer_params(params)
    h = constrain(_embed(rest, tokens, cfg), "batch", None, None)
    rope = _rope(torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S), cfg)
    wins = cfg.window_by_layer()
    body = _layer(cfg, hint=constrain)
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for li in range(cfg.n_layers):
        lp = _unrolled_slice(layer_params, li, cfg)
        if cfg.unrolled and cfg.seq_shard:  # Megatron-SP: boundaries split over S
            h = constrain(h, "batch", "model", None)
        if remat:
            h, aux, _, _ = checkpoint(body, h, lp, int(wins[li]), *rope, use_reentrant=False)
        else:
            h, aux, _, _ = body(h, lp, int(wins[li]), *rope)
        auxs.append(aux)
    h = common.rms_norm(h, rest["ln_f"], cfg.norm_eps)
    logits = _softcap(h @ _head(rest, cfg, h.dtype), cfg)
    return constrain(logits, "batch", None, "model"), _stack_aux(auxs)


def loss_fn(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """Next-token cross entropy (tokens double as labels, shifted), plus the
    MoE aux loss summed over layers; ``moe_drop_rate`` averaged."""
    logits, aux = forward(params, tokens, cfg)
    loss = common.softmax_xent(logits[:, :-1], tokens[:, 1:])
    metrics = {"xent": loss}
    if cfg.moe is not None:
        loss = loss + aux["moe_aux_loss"].sum()
        metrics["moe_drop_rate"] = aux["moe_drop_rate"].mean()
    return loss, metrics


# ---------------------------------------------------------------------------
# Prefill (serve: populate the KV cache, return next-token logits)
# ---------------------------------------------------------------------------


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens (B, S) -> (last-position logits (B, vocab) in fp32, KV cache
    {"k", "v": (L, B, S, KV, dh) bf16, "len": (B,) int32})."""
    B, S = tokens.shape
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    layer_params, rest = _split_layer_params(params)
    h = constrain(_embed(rest, tokens, cfg), "batch", None, None)
    rope = _rope(torch.arange(S, dtype=torch.int32, device=h.device)[None].expand(B, S), cfg)
    wins = cfg.window_by_layer()
    kc = vc = None  # (L, B, S, KV, dh), laid out as the first layer's K/V
    body = _layer(cfg)
    for li in range(cfg.n_layers):
        h, _, k, v = body(h, _unrolled_slice(layer_params, li, cfg), int(wins[li]), *rope)
        if kc is None:
            kc = sharding.empty_stack(cfg.n_layers, k, torch.bfloat16)
            vc = sharding.empty_stack(cfg.n_layers, v, torch.bfloat16)
        kc[li], vc[li] = k, v
    hl = common.rms_norm(h[:, -1], rest["ln_f"], cfg.norm_eps)
    logits = _softcap((hl @ _head(rest, cfg, hl.dtype)).to(torch.float32), cfg)
    cache = {"k": kc, "v": vc, "len": torch.full((B,), S, dtype=torch.int32, device=h.device)}
    return logits, cache


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    """Zero dense caches (L, batch, max_seq, KV, dh) on ``device`` (None:
    the card, raising without one)."""
    dev = device_lib.resolve(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def init_split_cache(cfg: TransformerConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                     device=None):
    """Windowed ring-buffer caches for local-attention layers.

    A layer with window w never reads K/V older than w tokens, so its cache
    is a ring of w slots instead of max_seq: exact attention semantics,
    cache bytes shrink by (n_loc·w + n_glob·S) / (L·S) (gemma3 decode_32k:
    6.2x).  Falls back to the dense cache when every layer is global.
    """
    dev = device_lib.resolve(device)
    wins = cfg.window_by_layer()
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    loc = [i for i, w in enumerate(wins) if int(w) < max_seq]
    glob = [i for i, w in enumerate(wins) if int(w) >= max_seq]
    if not loc:
        return init_cache(cfg, batch, max_seq, dtype, dev)
    w_max = max(int(wins[i]) for i in loc)
    cache = {
        "k_loc": torch.zeros((len(loc), batch, w_max, KV, dh), dtype=dtype, device=dev),
        "v_loc": torch.zeros((len(loc), batch, w_max, KV, dh), dtype=dtype, device=dev),
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }
    if glob:
        cache["k_glob"] = torch.zeros((len(glob), batch, max_seq, KV, dh), dtype=dtype, device=dev)
        cache["v_glob"] = torch.zeros((len(glob), batch, max_seq, KV, dh), dtype=dtype, device=dev)
    return cache


def _decode_layer(h, lp, cfg: TransformerConfig, rope, attend, act: str):
    """One layer of a decode step on (B, 1, d); ``attend(q, k, v)`` writes
    k/v into its cache and returns the attention output."""
    B, _, d = h.shape
    a = common.rms_norm(h, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(a, lp, cfg, rope)
    o = attend(q, k, v)
    h = h + o.reshape(B, 1, -1) @ lp["wo"].to(h.dtype)
    m = common.rms_norm(h, lp["ln2"], cfg.norm_eps)
    return h + _ffn(m, lp, cfg, act)[0]


def decode_step_split(params, cache, tokens: torch.Tensor, cfg: TransformerConfig):
    """``decode_step`` over split (ring local + dense global) caches from
    ``init_split_cache``: tokens (B,) -> (logits (B, vocab) fp32, cache).

    Writes the token's K/V into ``cache["k_loc"]``/``["v_loc"]`` (slot
    len % W) and ``["k_glob"]``/``["v_glob"]`` (position len) in place and
    returns those tensors with ``len + 1``.  Equals ``decode_step`` on a
    dense cache up to the order of fp32 sums (the logits are rounded to fp32
    before the softcap here, after it there, as in the reference).
    """
    if "k_loc" not in cache:  # all-global config: plain dense path
        return decode_step(params, cache, tokens, cfg)
    layer_params, rest = _split_layer_params(params)
    h = _embed(rest, tokens, cfg)[:, None, :]
    ln = cache["len"]
    rope = _rope(ln[:, None], cfg)
    wins = cfg.window_by_layer()
    max_seq = cache["k_glob"].shape[2] if "k_glob" in cache else None
    W = cache["k_loc"].shape[2]
    loc_map, glob_map = {}, {}
    for i, w in enumerate(wins):
        if max_seq is None or int(w) < max_seq:
            loc_map[i] = len(loc_map)
        else:
            glob_map[i] = len(glob_map)
    slot = torch.remainder(ln, W).long()
    for li in range(cfg.n_layers):
        if li in loc_map:
            kc, vc, at = cache["k_loc"][loc_map[li]], cache["v_loc"][loc_map[li]], slot
            fn = attention.ring_decode_attention
        else:
            kc, vc, at = cache["k_glob"][glob_map[li]], cache["v_glob"][glob_map[li]], ln.long()
            fn = attention.decode_attention

        def attend(q, k, v, kc=kc, vc=vc, at=at, fn=fn, w=int(wins[li])):
            sharding.write_rows(kc, at, k[:, 0].to(kc.dtype))
            sharding.write_rows(vc, at, v[:, 0].to(vc.dtype))
            return fn(q, kc, vc, ln, w)

        lp = _use_constrain_layer(_layer_slice(layer_params, li), cfg)
        h = _decode_layer(h, lp, cfg, rope, attend, cfg.act)
    hf = common.rms_norm(h[:, 0], rest["ln_f"], cfg.norm_eps)
    logits = _softcap((hf @ _head(rest, cfg, hf.dtype)).to(torch.float32), cfg)
    return logits, {**cache, "len": ln + 1}


def decode_step(params, cache, tokens: torch.Tensor, cfg: TransformerConfig):
    """One decode step on a dense cache: tokens (B,) -> (logits (B, vocab)
    fp32, cache).

    The new token attends to cache[:len] plus itself; each layer's K/V are
    written at position ``len`` of ``cache["k"]``/``cache["v"]`` in place,
    and those tensors come back with ``len + 1``.  The MoE FFN runs with the
    default activation here, as in the reference.
    """
    layer_params, rest = _split_layer_params(params)
    h = _embed(rest, tokens, cfg)[:, None, :]
    ln = cache["len"]
    rope = _rope(ln[:, None], cfg)
    wins = cfg.window_by_layer()
    at = ln.long()
    for li in range(cfg.n_layers):
        kc, vc = cache["k"][li], cache["v"][li]

        def attend(q, k, v, kc=kc, vc=vc, w=int(wins[li])):
            sharding.write_rows(kc, at, k[:, 0].to(kc.dtype))
            sharding.write_rows(vc, at, v[:, 0].to(vc.dtype))
            return attention.decode_attention(q, kc, vc, ln, w)

        h = _decode_layer(h, _unrolled_slice(layer_params, li, cfg), cfg, rope, attend, "silu")
    hf = common.rms_norm(h[:, 0], rest["ln_f"], cfg.norm_eps)
    logits = _softcap(hf @ _head(rest, cfg, hf.dtype), cfg)
    return logits.to(torch.float32), {"k": cache["k"], "v": cache["v"], "len": ln + 1}
