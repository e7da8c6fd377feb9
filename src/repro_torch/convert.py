"""State carried between the JAX package and the port, as numpy arrays.

``graph_from_numpy`` takes the reference ``KNNGraph`` fields as numpy arrays
(``{name: np.asarray(field)}``) and gives the port's graph;
``graph_to_numpy`` goes the other way; ``coarse_from_numpy`` and
``coarse_to_numpy`` do the same for a ``CoarseLevel``;
``build_config_from_dict`` carries a reference ``BuildConfig.__dict__``;
``encoded_from_numpy`` carries a reference ``EncodedData``;
``recsys_params_from_numpy`` and ``recsys_params_to_numpy`` carry a
recommender model's parameter tree, ``mace_params_from_numpy`` and
``mace_params_to_numpy`` MACE's, ``lm_params_from_numpy`` and
``lm_params_to_numpy`` an LM's, and ``opt_state_from_numpy`` and
``opt_state_to_numpy`` an optimizer's state (AdamW ``m``/``v``/``step``,
Adafactor ``vr``/``vc``/``step``, SGD ``step``).  Nothing here imports the
reference.
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


def _from_numpy(a) -> torch.Tensor:
    """A numpy array as a tensor, bit for bit.  JAX's bfloat16 arrives as
    ``ml_dtypes.bfloat16``, which torch cannot read: its bits are carried
    through int16 and viewed as ``torch.bfloat16``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def encoded_from_numpy(fields: dict, device="cpu") -> EncodedData:
    """Reference ``EncodedData`` fields as numpy (``{name: np.asarray(field)
    or None}``) -> the port's ``EncodedData``.  JAX's bfloat16 arrives as
    ``ml_dtypes.bfloat16``, which torch cannot read (``_from_numpy``)."""

    def tensor(a):
        return None if a is None else _from_numpy(a).to(device)

    return EncodedData(**{name: tensor(fields.get(name)) for name in EncodedData._fields})


def recsys_params_from_numpy(tree: dict, cfg, device="cpu") -> dict:
    """A reference recommender parameter tree (nested dicts of numpy
    leaves) -> the port's parameter dict, each leaf in ``cfg.param_dtype``
    on ``device``.  The tree must hold the leaves, of the shapes, that the
    port's ``recsys.init_params`` makes for ``cfg``; raises naming the first
    that differs."""
    from repro_torch.models import recsys

    # the tree's layout from a one-id-per-field copy; tables scale with it
    want = recsys.init_params(torch.Generator().manual_seed(0),
                              dataclasses.replace(cfg, vocab_per_field=1))
    rows = cfg.total_rows if cfg.name in ("deepfm", "xdeepfm") else cfg.vocab_per_field
    dt = getattr(torch, cfg.param_dtype)

    def carry(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{cfg.name} params{path}: keys {got} != {sorted(spec)}")
            return {k: carry(node[k], spec[k], f"{path}[{k!r}]") for k in spec}
        a = np.asarray(node)
        shape = tuple(spec.shape)
        if path in ("['table']", "['lin_table']"):
            shape = (rows,) + shape[1:]
        if a.shape != shape:
            raise ValueError(f"{cfg.name} params{path}: shape {a.shape} != {shape}")
        return torch.from_numpy(a.copy()).to(device=device, dtype=dt)

    return carry(tree, want, "")


def recsys_params_to_numpy(params: dict) -> dict:
    """The port's recommender parameter dict -> nested dicts of numpy
    arrays, the reference's tree layout."""
    if isinstance(params, dict):
        return {k: recsys_params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def mace_params_from_numpy(tree: dict, cfg, device="cpu") -> dict:
    """A reference MACE parameter dict of numpy leaves -> the port's, each
    leaf in ``cfg.param_dtype`` on ``device``.  The keys and shapes must be
    the ones the port's ``mace.init_params`` makes for ``cfg``; raises
    naming the first that differs."""
    from repro_torch.models import mace

    want = {k: tuple(v.shape) for k, v in mace.init_params(torch.Generator(), cfg).items()}
    if set(tree) != set(want):
        raise ValueError(f"{cfg.name} params: keys {sorted(tree)} != {sorted(want)}")
    dt = getattr(torch, cfg.param_dtype)
    out = {}
    for k, shape in want.items():
        a = np.asarray(tree[k])
        if a.shape != shape:
            raise ValueError(f"{cfg.name} params[{k!r}]: shape {a.shape} != {shape}")
        out[k] = torch.from_numpy(a.copy()).to(device=device, dtype=dt)
    return out


def lm_params_from_numpy(tree: dict, cfg, device="cpu") -> dict:
    """A reference LM parameter dict of numpy leaves (bf16 leaves as
    ``ml_dtypes.bfloat16``) -> the port's, each leaf in the dtype the
    port's ``transformer.init_params`` gives it (``cfg.param_dtype``, the
    router fp32) on ``device``: bit for bit where the dtypes agree.  The
    keys and shapes must be ``init_params``'s for ``cfg``; raises naming the
    first that differs."""
    from repro_torch.models import transformer

    want = transformer.param_shapes(cfg)
    if set(tree) != set(want):
        raise ValueError(f"{cfg.name} params: keys {sorted(tree)} != {sorted(want)}")
    out = {}
    for k, (shape, dt) in want.items():
        a = np.asarray(tree[k])
        if a.shape != shape:
            raise ValueError(f"{cfg.name} params[{k!r}]: shape {a.shape} != {shape}")
        out[k] = _from_numpy(a).to(device=device, dtype=dt)
    return out


def lm_params_to_numpy(params: dict) -> dict:
    """The port's LM parameter dict -> {name: numpy array}, the reference's
    layout; bf16 leaves widen to float32 (exactly: numpy has no bfloat16)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
            for k, v in params.items()}


_OPT_KEYS = {frozenset({"m", "v", "step"}), frozenset({"vr", "vc", "step"}), frozenset({"step"})}


def opt_state_from_numpy(tree: dict, device="cpu") -> dict:
    """A reference optimizer state (``init_opt_state``'s dict, numpy
    leaves) -> the port's: float leaves as float32 tensors on ``device``,
    ``step`` an int32 scalar tensor."""
    if frozenset(tree) not in _OPT_KEYS:
        raise ValueError(f"optimizer state keys {sorted(tree)}: not AdamW, Adafactor or SGD")

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32)).to(device)

    out = {k: carry(v) for k, v in tree.items() if k != "step"}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=device)
    return out


# MACE's parameters and an optimizer's state (``step`` an int32 scalar) go
# to the reference's layout as any tree of tensors does
mace_params_to_numpy = opt_state_to_numpy = recsys_params_to_numpy
