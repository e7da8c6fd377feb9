"""State carried between the JAX package and the port, as numpy arrays.

``graph_from_numpy`` takes the reference ``KNNGraph`` fields as numpy arrays
(``{name: np.asarray(field)}``) and gives the port's graph;
``graph_to_numpy`` goes the other way; ``coarse_from_numpy`` and
``coarse_to_numpy`` do the same for a ``CoarseLevel``;
``build_config_from_dict`` carries a reference ``BuildConfig.__dict__``;
``encoded_from_numpy`` carries a reference ``EncodedData``.  Nothing here
imports the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.construct import BuildConfig
from repro_torch.core.graph import KNNGraph
from repro_torch.core.hierarchy import CoarseLevel
from repro_torch.kernels.precision import EncodedData

_DTYPES = {
    "nbr_ids": torch.int32,
    "nbr_dist": torch.float32,
    "nbr_lam": torch.int32,
    "rev_ids": torch.int32,
    "rev_lam": torch.int32,
    "rev_ptr": torch.int32,
    "alive": torch.bool,
    "sq_norms": torch.float32,
    "row_scale": torch.float32,
}


def graph_from_numpy(fields: dict, device="cpu") -> KNNGraph:
    """Reference graph fields (numpy) -> the port's ``KNNGraph``."""
    kw = {
        name: torch.from_numpy(np.array(fields[name])).to(device=device, dtype=dt)
        for name, dt in _DTYPES.items()
    }
    return KNNGraph(n_valid=int(fields["n_valid"]), **kw)


def graph_to_numpy(g: KNNGraph) -> dict:
    """The port's graph -> {field: numpy array}, ``n_valid`` as an int32
    scalar like the reference's."""
    out = {name: getattr(g, name).cpu().numpy() for name in _DTYPES}
    out["n_valid"] = np.int32(g.n_valid)
    return out


_COARSE = ("landmark_rows", "points", "members", "mem_ptr")


def coarse_from_numpy(fields: dict, device="cpu") -> CoarseLevel:
    """Reference ``CoarseLevel`` fields as numpy (``graph`` itself a dict of
    graph fields) -> the port's ``CoarseLevel``."""
    kw = {name: torch.from_numpy(np.array(fields[name])).to(device) for name in _COARSE}
    kw["points"] = kw["points"].float()
    return CoarseLevel(graph=graph_from_numpy(fields["graph"], device), **kw)


def coarse_to_numpy(c: CoarseLevel) -> dict:
    """The port's ``CoarseLevel`` -> {field: numpy array}, ``graph`` a dict."""
    out = {name: getattr(c, name).cpu().numpy() for name in _COARSE}
    out["graph"] = graph_to_numpy(c.graph)
    return out


# Reference BuildConfig fields with no counterpart here: engine selection
# follows the tensor's device, so ``dispatch``/``use_pallas`` carry no
# meaning and are dropped.
_DROPPED = ("dispatch", "use_pallas")
_FIELDS = frozenset(f.name for f in dataclasses.fields(BuildConfig))
# every BuildConfig field that either package knows
CONFIG_KEYS = _FIELDS | set(_DROPPED)


def build_config_from_dict(d: dict) -> BuildConfig:
    """A reference ``BuildConfig.__dict__`` -> the port's ``BuildConfig``.

    Every field but the engine selection is carried (``intra_wave``,
    ``data_bf16``, ``precision``, ``rerank_factor``, the coarse-seeding
    fields); raises for fields neither package knows (``CONFIG_KEYS``)."""
    unknown = set(d) - CONFIG_KEYS
    if unknown:
        raise ValueError(f"unknown BuildConfig fields: {sorted(unknown)}")
    return BuildConfig(**{key: v for key, v in d.items() if key in _FIELDS})


def encoded_from_numpy(fields: dict, device="cpu") -> EncodedData:
    """Reference ``EncodedData`` fields as numpy (``{name: np.asarray(field)
    or None}``) -> the port's ``EncodedData``.  JAX's bfloat16 arrives as
    ``ml_dtypes.bfloat16``, which torch cannot read: its bits are carried
    through int16."""

    def tensor(a):
        if a is None:
            return None
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
        return torch.from_numpy(a.copy()).to(device)

    return EncodedData(**{name: tensor(fields.get(name)) for name in EncodedData._fields})
