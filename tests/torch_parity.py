"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; these
helpers replay the reference's ``jax.random`` entry-point stream so the port
can be fed the same seeds, and move graphs between the two as numpy.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brute as jbrute
from repro.core import construct as jconstruct
from repro.kernels import precision as jprec
from repro_torch import convert
from repro_torch.core import brute as tbrute
from repro_torch.core import construct as tconstruct

GRAPH_FIELDS = (
    "nbr_ids", "nbr_dist", "nbr_lam", "rev_ids", "rev_lam", "rev_ptr",
    "alive", "n_valid", "sq_norms", "row_scale",
)


def int_data(n: int, d: int, seed: int = 0, high: int = 16) -> np.ndarray:
    """Small-integer-valued float32 rows: l2/ip/l1 sums are exact in fp32
    whatever the summation order, so ids and graphs compare bit for bit."""
    return np.random.RandomState(seed).randint(0, high, (n, d)).astype(np.float32)


def gauss_data(n: int, d: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


# the reference's exact_seed_graph runs op by op when called eagerly; one
# compile of the whole function is an order of magnitude faster on the CPU
jax_exact_seed_graph = jax.jit(
    jbrute.exact_seed_graph, static_argnums=(1, 2, 3),
    static_argnames=("capacity", "rev_capacity", "use_pallas", "dispatch"),
)


@contextlib.contextmanager
def compiled_reference():
    """Within the block, the reference functions that its builds and
    snapshot loads call outside any compiled step — ``brute.exact_seed_graph``
    (the seed graph and a coarse level's landmark graph),
    ``hierarchy.note_inserted`` (the seed prefix's cell assignment),
    ``graph.rebuild_reverse`` (restores, and each refine's reverse lists
    through ``nndescent``'s own name for it), ``graph.attach_sq_norms`` and
    ``nndescent._reverse_sample`` (integer work only) — run compiled once
    per shape instead of op by op: the same functions, at a tenth of their
    first-call time on the CPU.  And ``nndescent._join_round`` pads its
    nodes to one chunk of at most n rows instead of ``node_chunk`` (2048):
    with n <= 2048 there is one chunk either way and padded rows propose
    nothing, so the lists are the same, at a quarter of the CPU time of a
    512-row refine."""
    from repro.core import graph as jgraph
    from repro.core import hierarchy as jhier
    from repro.core import nndescent as jnnd

    join_round = jnnd._join_round

    def join_round_unpadded(x, ids, dist, is_new, rev_ids, rev_new, metric, dispatch, chunk):
        return join_round(x, ids, dist, is_new, rev_ids, rev_new, metric, dispatch,
                          min(chunk, ids.shape[0]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbrute, "exact_seed_graph", jax_exact_seed_graph)
        mp.setattr(jnnd, "_reverse_sample", jax.jit(jnnd._reverse_sample, static_argnums=(2,)))
        mp.setattr(jnnd, "_join_round", join_round_unpadded)
        for module, name in ((jhier, "note_inserted"), (jgraph, "rebuild_reverse"),
                             (jgraph, "attach_sq_norms")):
            mp.setattr(module, name, jax.jit(getattr(module, name)))
        mp.setattr(jnnd, "rebuild_reverse", jgraph.rebuild_reverse)
        yield


def encoded_numpy(enc) -> dict:
    """Reference ``EncodedData`` -> {field: numpy array or None}."""
    return {name: None if v is None else np.asarray(v) for name, v in enc._asdict().items()}


def encode_both(x: np.ndarray, precision: str, **kw):
    """The reference's ``EncodedData`` of x and the port's copy of it."""
    enc_j = jprec.encode_dataset(jnp.asarray(x), precision, **kw)
    return enc_j, convert.encoded_from_numpy(encoded_numpy(enc_j))


def jax_graph_numpy(g) -> dict:
    """Reference ``KNNGraph`` -> {field: numpy array}."""
    return {name: np.asarray(getattr(g, name)) for name in GRAPH_FIELDS}


def to_torch_graph(g_jax):
    return convert.graph_from_numpy(jax_graph_numpy(g_jax))


class JaxDraws:
    """A ``repro_torch.core.draws.Draws`` that replays a ``jax.random`` key:
    ``fold_in``/``split`` derive keys as the reference does, and the draws
    are the reference's ``randint``/``choice``/``permutation`` of the key,
    handed over as torch tensors."""

    def __init__(self, key):
        self.key = key

    def fold_in(self, data: int) -> "JaxDraws":
        return JaxDraws(jax.random.fold_in(self.key, data))

    def split(self):
        a, b = jax.random.split(self.key)
        return JaxDraws(a), JaxDraws(b)

    def randint(self, shape, high: int, device=None) -> torch.Tensor:
        a = jax.random.randint(self.key, tuple(shape), 0, max(int(high), 1), dtype=jnp.int32)
        return torch.from_numpy(np.array(a)).to(device)

    def choice(self, n: int, size: int, device=None) -> torch.Tensor:
        a = jax.random.choice(self.key, n, shape=(size,), replace=False).astype(jnp.int32)
        return torch.from_numpy(np.array(a)).to(device)

    def permutation(self, n: int, device=None) -> torch.Tensor:
        return torch.from_numpy(np.array(jax.random.permutation(self.key, n))).to(device)


def mind_routing_init(S: int, K: int) -> torch.Tensor:
    """The reference's fixed MIND routing logits for histories of length S
    (``repro.models.recsys.capsule_routing``: ``normal(PRNGKey(7), (1, S,
    K))``), as the port's ``routing_init(S, K)``."""
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(7), (1, S, K))[0]))


def draws(seed: int) -> JaxDraws:
    return JaxDraws(jax.random.PRNGKey(seed))


def search_seeds(key, B: int, p: int, n_valid: int) -> np.ndarray:
    """The (B, p) entry points ``repro.core.search.init_state`` draws from
    ``key`` under random seeding (``search.py:391``)."""
    return np.asarray(
        jax.random.randint(key, (B, p), 0, max(int(n_valid), 1), dtype=jnp.int32)
    )


def search_entry(key, B: int, p: int, n_valid: int, n_landmarks=None):
    """What ``repro.core.search.init_state`` draws from ``key``: the (B, p)
    seeds under random seeding; under coarse seeding (``n_landmarks`` given)
    the pair (seeds, coarse-pass seeds) from its ``key_c, key_r`` split
    (``search.py:374``), the coarse pass drawing over the landmarks."""
    if n_landmarks is None:
        return torch.from_numpy(np.array(search_seeds(key, B, p, n_valid)))
    key_c, key_r = jax.random.split(key)
    return (torch.from_numpy(np.array(search_seeds(key_r, B, p, n_valid))),
            torch.from_numpy(np.array(search_seeds(key_c, B, p, n_landmarks))))


def build_seed_fn(key, p: int, n_landmarks=None):
    """A port ``seed_fn`` replaying the reference build's key chain: one
    ``key, sk = split(key)`` per wave (``construct.py:490``), then the
    search's draw from ``sk`` over the rows committed so far (and over the
    landmarks under coarse seeding)."""
    subkeys = []

    def seed_fn(wave: int, pos: int, W: int, n_valid: int):
        nonlocal key
        while len(subkeys) <= wave:
            key, sk = jax.random.split(key)
            subkeys.append(sk)
        return search_entry(subkeys[wave], W, p, n_valid, n_landmarks)

    return seed_fn


def search_seed_fn(key, p: int, n_landmarks=None):
    """A port search ``seed_fn(B, n_valid)`` replaying a chain of searches
    from ``key``, one ``key, k = split(key)`` per search
    (``ServingLoop._next_key``, ``loop.py:147``)."""

    def seed_fn(B: int, n_valid: int):
        nonlocal key
        key, k = jax.random.split(key)
        return search_entry(k, B, p, n_valid, n_landmarks)

    return seed_fn


def fixed_seed_fn(key, p: int, n_landmarks=None):
    """A port search ``seed_fn`` that draws from the same ``key`` on every
    call, as ``OnlineIndex.search`` does with its default ``PRNGKey(0)``."""
    return lambda B, n_valid: search_entry(key, B, p, n_valid, n_landmarks)


def coarse_build_kw(key, n: int, L: int, p: int) -> tuple:
    """The reference's from-scratch coarse build (``construct.py:509-513``,
    ``hierarchy.py:703-707``) as port keyword arguments: ``key, ck =
    split(key)``; the landmarks are ``choice(key_s, n, (L,))`` and the
    landmark graph builds from ``key_b``; the waves replay ``key``."""
    key, ck = jax.random.split(key)
    key_s, key_b = jax.random.split(ck)
    rows = jax.random.choice(key_s, n, shape=(L,), replace=False).astype(jnp.int32)
    return dict(
        seed_fn=build_seed_fn(key, p, L),
        landmark_rows=torch.from_numpy(np.array(rows)),
        landmark_seed_fn=build_seed_fn(key_b, p),
    )


def derive_coarse_kw(key, alive: np.ndarray, n_valid: int, L, p: int) -> dict:
    """The reference's ``derive_coarse(g, x, cfg, key)`` draws
    (``hierarchy.py:758-769``) as port keyword arguments: landmarks are a
    permutation of the alive rows, the landmark graph builds from
    ``key_b``.  ``L`` None takes the default count."""
    from repro.core import hierarchy as jhier

    rows = np.nonzero(np.asarray(alive)[:n_valid])[0].astype(np.int32)
    L = min(L or jhier.default_landmarks(rows.size), rows.size)
    key_s, key_b = jax.random.split(key)
    perm = np.array(jax.random.permutation(key_s, rows.size)[:L])
    return dict(landmark_rows=torch.from_numpy(rows[perm]),
                landmark_seed_fn=build_seed_fn(key_b, p))


def insert_kw(key, p: int, *, coarse_derive=None, n_landmarks=None) -> dict:
    """``repro.core.dynamic.insert``'s draws from ``key`` as port keyword
    arguments.  ``coarse_derive=(alive, n_valid, L)`` when the insert
    derives a coarse level first (``construct.py:499-502``)."""
    kw = {}
    if coarse_derive is not None:
        key, ck = jax.random.split(key)
        alive, n_valid, L = coarse_derive
        kw = derive_coarse_kw(ck, alive, n_valid, L, p)
        n_landmarks = len(kw["landmark_rows"])
    kw["seed_fn"] = build_seed_fn(key, p, n_landmarks)
    return kw


def coarse_numpy(c) -> dict:
    """Reference ``CoarseLevel`` -> numpy fields, ``graph`` a dict."""
    out = {name: np.asarray(getattr(c, name))
           for name in ("landmark_rows", "points", "members", "mem_ptr")}
    out["graph"] = jax_graph_numpy(c.graph)
    return out


def assert_coarse_equal(c_torch, c_jax, err: str = "") -> None:
    got = convert.coarse_to_numpy(c_torch)
    want = coarse_numpy(c_jax)
    for name in ("landmark_rows", "points", "members", "mem_ptr"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{err} coarse {name}")
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(got["graph"][name], want["graph"][name],
                                      err_msg=f"{err} coarse graph {name}")


def build_both(x: np.ndarray, seed: int, **kw):
    """The reference build (``dispatch="reference"``) from ``PRNGKey(seed)``
    and the port's CPU build from the same replayed entry points:
    ((graph, stats) of the reference, (graph, stats) of the port)."""
    jcfg = jconstruct.BuildConfig(dispatch="reference", **kw)
    g_j, st_j = jconstruct.build(jnp.asarray(x), jcfg, jax.random.PRNGKey(seed))
    g_t, st_t = tconstruct.build(
        torch.from_numpy(x), tconstruct.BuildConfig(**kw),
        seed_fn=build_seed_fn(jax.random.PRNGKey(seed), kw["n_seeds"]), device="cpu",
    )
    return (g_j, st_j), (g_t, st_t)


def graph_recalls(x: np.ndarray, g_t, g_j, k: int = 10) -> tuple[float, float]:
    """Graph recall@k of the port's and the reference's graph over every
    row, against brute force with the self-match excluded."""
    n = x.shape[0]
    truth, _ = tbrute.brute_force_knn(
        torch.from_numpy(x), torch.from_numpy(x), k,
        exclude_ids=torch.arange(n, dtype=torch.int32), device="cpu",
    )
    r_t = tbrute.recall_at_k(g_t.nbr_ids, truth, k)
    r_j = tbrute.recall_at_k(torch.from_numpy(np.array(g_j.nbr_ids)), truth, k)
    return r_t, r_j


def assert_graphs_equal(g_torch, g_jax, err: str = "") -> None:
    """Every graph field bit for bit."""
    got = convert.graph_to_numpy(g_torch)
    want = jax_graph_numpy(g_jax)
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=f"{err} field {name}")


def online_index_both(x: np.ndarray, cfg: dict, seed: int = 1, **kw):
    """``OnlineIndex.build`` of the reference (``dispatch="reference"``)
    from ``PRNGKey(seed)`` and of the port from the replayed draws."""
    from repro.index import OnlineIndex as JIndex
    from repro_torch.index import OnlineIndex as TIndex

    key = jax.random.PRNGKey(seed)
    jidx = JIndex.build(jnp.asarray(x), jconstruct.BuildConfig(dispatch="reference", **cfg),
                        key=key, **kw)
    if cfg.get("seed_mode") == "coarse":
        inject = coarse_build_kw(key, len(x), cfg["coarse_landmarks"], cfg["n_seeds"])
    else:
        inject = dict(seed_fn=build_seed_fn(key, cfg["n_seeds"]))
    tidx = TIndex.build(torch.from_numpy(x), tconstruct.BuildConfig(**cfg), device="cpu",
                        **inject, **kw)
    return jidx, tidx


def assert_index_equal(tidx, jidx, err: str = "") -> None:
    """Graph, data, ledger, sizes and coarse level of two ``OnlineIndex``es."""
    assert_graphs_equal(tidx.graph, jidx.graph, err)
    np.testing.assert_array_equal(tidx.items.numpy(), np.asarray(jidx.items), err_msg=err)
    assert tidx.free_ids == tuple(int(i) for i in jidx.free_ids), err
    assert (tidx.capacity, tidx.n_items, tidx.n_pending) == (
        jidx.capacity, jidx.n_items, jidx.n_pending), err
    assert (tidx.coarse is None) == (jidx.coarse is None), err
    if tidx.coarse is not None:
        assert_coarse_equal(tidx.coarse, jidx.coarse, err)


def n_landmarks(idx):
    return None if idx.coarse is None else idx.coarse.n_landmarks


def add_both(jidx, tidx, rows: np.ndarray, seed: int, flush: bool = True) -> None:
    """The same rows added to both indexes, the insertion keyed by
    ``PRNGKey(seed)`` and replayed."""
    key = jax.random.PRNGKey(seed)
    jidx.add(jnp.asarray(rows), key=key, flush=flush)
    tidx.add(torch.from_numpy(rows), seed_fn=build_seed_fn(key, tidx.build_cfg.n_seeds,
                                                           n_landmarks(tidx)), flush=flush)


def search_both(jidx, tidx, q: np.ndarray, k: int, beam=None, seed: int = 0):
    """One search of both indexes from ``PRNGKey(seed)``; ids, distances,
    counters and ``seed_cell`` must be equal."""
    key = jax.random.PRNGKey(seed)
    want = jidx.search(jnp.asarray(q), k, beam=beam, key=key)
    got = tidx.search(torch.from_numpy(q), k, beam=beam,
                      seed_fn=fixed_seed_fn(key, tidx.build_cfg.n_seeds, n_landmarks(tidx)))
    for name in ("ids", "dists", "n_comps", "hash_full", "seed_cell"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    return got, want


# ---------------------------------------------------------------------------
# the LM family (tests/test_torch_transformer.py, test_torch_decode.py)
# ---------------------------------------------------------------------------

LM_ARCHS = ("mixtral-8x7b", "arctic-480b", "stablelm-1.6b", "qwen2.5-3b", "gemma3-1b")
# tight: fp32 compute (``tests/test_models.py::_cfg``'s choice); loose: the
# smoke configs' own bf16 compute over fp32 parameters
LM_TIERS = ("float32", "bfloat16")
RTOL, ATOL = 1e-5, 1e-6
BF16_ULP = 2.0 ** -7
# the loose tier's bound, a share of the largest element: on the smoke
# configs' inputs the logits of forward, prefill and both decode steps, and
# the decode caches, differ from the reference's by at most 0.68% of their
# largest (gemma3's dense decode; forward 0.39-0.66%, prefill 0.24-0.35%)
LM_LOOSE = 2.0 ** -6


def lm_configs(arch, tier):
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    jc, tc = jconfigs.get(arch).smoke_config(), tconfigs.get(arch).smoke_config()
    if tier == "float32":
        jc = dataclasses.replace(jc, compute_dtype="float32")
        tc = dataclasses.replace(tc, compute_dtype="float32")
    return jc, tc


@functools.lru_cache(maxsize=None)
def lm_problem(arch, tier):
    """(reference config, port config, reference params, port params) of an
    LM arch's smoke config at a tier, the params from PRNGKey(0) carried
    across."""
    from repro.models import transformer as jtfm

    jc, tc = lm_configs(arch, tier)
    pj = jtfm.init_params(jax.random.PRNGKey(0), jc)
    pt = convert.lm_params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, tc)
    return jc, tc, pj, pt


def lm_tokens(vocab, shape, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


def lm_close(got, want, tier):
    """fp32 tier: rtol 1e-5 and 1e-6 of the largest element (an element near
    zero keeps the absolute rounding of the d products it sums, which
    scales with the row, not with itself); bf16 tier: ``LM_LOOSE`` of the
    largest element."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if tier == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=LM_LOOSE * np.abs(want).max())


def bf16_close(got, want):
    """A bf16 tensor computed in fp32 and rounded once, on both sides: one
    bf16 rounding (a value on a boundary may round either way) on top of
    the fp32 bound."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP,
                               atol=ATOL * np.abs(want).max())
