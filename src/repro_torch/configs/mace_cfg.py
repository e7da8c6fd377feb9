"""mace [arXiv:2206.07697]: n_layers=2 d_hidden=128 l_max=2 correlation=3
n_rbf=8, E(3) equivariance (Cartesian-tensor carrier, ``models/mace.py``).
Counterpart of ``repro.configs.mace_cfg``.

Four data regimes: cora-size full batch, reddit-size sampled mini-batches
(fanout 15-10), products-size full batch, and batched small molecules
(whose k-NN edges come from their positions)."""

from repro_torch.models.mace import MACEConfig

ARCH = "mace"
FAMILY = "gnn"

SHAPES = {
    "full_graph_sm": {
        "kind": "train",
        "n_nodes": 2708,
        "n_edges": 10556,
        "d_feat": 1433,
        "n_classes": 7,
    },
    "minibatch_lg": {
        "kind": "train",
        "n_nodes": 232_965,
        "n_edges": 114_615_892,
        "batch_nodes": 1024,
        "fanout": (15, 10),
        "d_feat": 602,
        "n_classes": 41,
    },
    "ogb_products": {
        "kind": "train",
        "n_nodes": 2_449_029,
        "n_edges": 61_859_140,
        "d_feat": 100,
        "n_classes": 47,
    },
    "molecule": {
        "kind": "train",
        "n_nodes": 30,
        "n_edges": 64,
        "batch": 128,
    },
}
SKIP = {}


def full_config(shape: str = "molecule") -> MACEConfig:
    base = dict(n_layers=2, d_hidden=128, l_max=2, correlation=3, n_rbf=8)
    if shape == "molecule":
        return MACEConfig(name=ARCH, n_species=8, **base)
    s = SHAPES[shape]
    return MACEConfig(
        name=ARCH,
        n_species=1,
        d_node_feat=s["d_feat"],
        n_classes=s["n_classes"],
        **base,
    )


def smoke_config(shape: str = "molecule") -> MACEConfig:
    base = dict(n_layers=2, d_hidden=16, l_max=2, correlation=3, n_rbf=4, readout_hidden=8)
    if shape == "molecule":
        return MACEConfig(name=ARCH + "-smoke", n_species=4, **base)
    return MACEConfig(
        name=ARCH + "-smoke", n_species=1, d_node_feat=24, n_classes=5, **base
    )
