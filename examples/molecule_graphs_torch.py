"""The paper's technique inside the GNN pipeline on the PyTorch port: the
k-NN graph of an atom cloud, built online, consumed by MACE (the
counterpart of ``examples/molecule_graphs.py``).

    PYTHONPATH=src python examples/molecule_graphs_torch.py               # on the card
    PYTHONPATH=src python examples/molecule_graphs_torch.py --device cpu

For a large point cloud MACE's neighbour graph is built with the paper's
online LGD construction (``repro_torch.build``) instead of brute force:
3,000 atoms uniform in a 30³ box, k=8, l2, waves of 256.  It prints the
build's scanning rate and its edge recall against ``brute_force_knn``, then
computes MACE's energy and forces over the graph's edges.  Positions,
species and parameters are random, drawn from seeded generators on the
device.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import BuildConfig, build
from repro_torch import device as device_lib
from repro_torch.core import brute, construct
from repro_torch.models import mace

N_ATOMS, K, BOX = 3000, 8, 30.0


def edges(nbr_ids: torch.Tensor) -> tuple:
    """(senders, receivers) of a k-NN list (n, k); -1 slots dropped."""
    n, k = nbr_ids.shape
    valid = (nbr_ids >= 0).reshape(-1)
    receivers = torch.arange(n, dtype=torch.int32, device=nbr_ids.device).repeat_interleave(k)
    return nbr_ids.reshape(-1)[valid], receivers[valid]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--n-atoms", type=int, default=N_ATOMS)
    args = ap.parse_args(argv)
    dev = device_lib.resolve(args.device)
    n = args.n_atoms

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    pos = torch.rand((n, 3), generator=gen(0), device=dev) * BOX
    species = torch.randint(0, 4, (n,), generator=gen(1), device=dev)

    # --- neighbour graph via the paper's online construction ----------------
    cfg = BuildConfig(k=K, metric="l2", wave=256, lgd=True)
    sync()
    t0 = time.perf_counter()
    g, stats = build(pos, cfg, generator=gen(0), device=dev)
    sync()
    build_s = time.perf_counter() - t0
    rate = construct.scanning_rate(stats, n)
    print(f"LGD neighbour graph over {n} atoms on {dev} in {build_s:.3f}s "
          f"(scanning rate {rate:.4f})")
    tids, _ = brute.brute_force_knn(pos, pos, K, "l2",
                                    exclude_ids=torch.arange(n, dtype=torch.int32, device=dev),
                                    device=dev)
    recall = brute.recall_at_k(g.nbr_ids[:n], tids, K)
    print(f"edge recall vs the exact k-NN graph: {recall:.4f}")

    # --- consume the graph in MACE -------------------------------------------
    senders, receivers = edges(g.nbr_ids[:n])
    mcfg = mace.MACEConfig(n_layers=2, d_hidden=32, n_rbf=8, n_species=4, readout_hidden=16,
                           r_cut=6.0)
    params = mace.init_params(gen(2), mcfg)
    sync()
    t0 = time.perf_counter()
    e = mace.energy(params, pos, species, senders, receivers, mcfg)
    f = mace.forces(params, pos, species, senders, receivers, mcfg)
    sync()
    mace_s = time.perf_counter() - t0
    print(f"MACE energy {float(e):.3f} + forces {tuple(f.shape)} over the LGD graph's "
          f"{senders.numel()} edges in {mace_s:.3f}s (max |F| = {float(f.abs().max()):.3f})")
    return {"device": str(dev), "n_atoms": n, "build_s": build_s, "scanning_rate": rate,
            "recall": recall, "n_edges": senders.numel(), "energy": float(e), "forces": f,
            "mace_s": mace_s, "nbr_ids": g.nbr_ids[:n]}


if __name__ == "__main__":
    main()
