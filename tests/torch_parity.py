"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; these
helpers replay the reference's ``jax.random`` entry-point stream so the port
can be fed the same seeds, and move graphs between the two as numpy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
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
jax_exact_seed_graph = jax.jit(jbrute.exact_seed_graph, static_argnums=(1, 2, 3))


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


def search_seeds(key, B: int, p: int, n_valid: int) -> np.ndarray:
    """The (B, p) entry points ``repro.core.search.init_state`` draws from
    ``key`` under random seeding (``search.py:391``)."""
    return np.asarray(
        jax.random.randint(key, (B, p), 0, max(int(n_valid), 1), dtype=jnp.int32)
    )


def build_seed_fn(key, p: int):
    """A port ``seed_fn`` replaying the reference build's key chain: one
    ``key, sk = split(key)`` per wave (``construct.py:490``), then the
    search's draw from ``sk`` over the rows committed so far."""
    subkeys = []

    def seed_fn(wave: int, pos: int, W: int, n_valid: int):
        nonlocal key
        while len(subkeys) <= wave:
            key, sk = jax.random.split(key)
            subkeys.append(sk)
        return torch.from_numpy(np.array(search_seeds(subkeys[wave], W, p, n_valid)))

    return seed_fn


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
