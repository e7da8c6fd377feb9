"""Port MACE (``repro_torch.models.mace``), its config and the parameter
carry of ``convert``, against the JAX package on the same numpy inputs.

The reference's parameters are carried across with
``convert.mace_params_from_numpy``.  ``forward``, ``energy``, ``forces``,
both losses and their parameter gradients (against ``jax.grad``) agree to
rtol 1e-5, atol 1e-6 in fp32 (``segment_sum`` and ``index_add`` add in
different orders).  The reference's own properties are mirrored on the
port: rotation and translation invariance of the energy, rotation
equivariance of the forces, inert padded edges, zeroed masked nodes, and a
node-classification run whose loss falls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mace_cfg as jmace_cfg
from repro.data import graphs as jgraphs
from repro.models import mace as jmace
from repro_torch import convert
from repro_torch.configs import mace_cfg as tmace_cfg
from repro_torch.data import graphs as tgraphs
from repro_torch.models import mace as tmace
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def close_trees(got, want, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], rtol, atol)


@functools.cache
def carried(shape):
    jcfg, tcfg = jmace_cfg.smoke_config(shape), tmace_cfg.smoke_config(shape)
    pj = jmace.init_params(jax.random.PRNGKey(0), jcfg)
    pt = convert.mace_params_from_numpy(jax.tree.map(np.asarray, pj), tcfg)
    return jcfg, tcfg, pj, pt


@pytest.fixture(scope="module")
def mol():
    """One 12-atom molecule with its 4-NN edges (the reference's fixture,
    its species drawn within the smoke config's 4)."""
    pos, spec = jgraphs.molecules(jax.random.PRNGKey(0), 1, 12, n_species=4)
    snd, rcv = jgraphs.knn_edges_from_positions(pos[0], 4)
    arrays = [np.asarray(a) for a in (pos[0], spec[0], snd, rcv)]
    return tuple(map(jnp.asarray, arrays)), tuple(torch.from_numpy(a.copy()) for a in arrays)


@pytest.fixture(scope="module")
def cora():
    """A 60-node citation-style graph with features, labels and a train mask."""
    g = jgraphs.random_graph(jax.random.PRNGKey(1), 60, 240, 24, n_classes=5)
    mask = np.arange(60) % 3 != 0
    batch = dict(positions=np.zeros((60, 3), np.float32), species=np.zeros(60, np.int32),
                 senders=np.asarray(g.senders), receivers=np.asarray(g.receivers),
                 node_feat=np.asarray(g.features), labels=np.asarray(g.labels), train_mask=mask)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})


def test_basis_functions_match_the_reference():
    r = np.linspace(0.0, 6.0, 50).astype(np.float32)
    close(tmace.bessel_rbf(torch.from_numpy(r), 8, 5.0), jmace.bessel_rbf(jnp.asarray(r), 8, 5.0))
    vec = np.random.RandomState(0).randn(40, 3).astype(np.float32)
    vec[:3] = 0.0  # self loops
    close(tmace.safe_norm(torch.from_numpy(vec)), jmace.safe_norm(jnp.asarray(vec)))
    for a, b in zip(tmace.edge_harmonics(torch.from_numpy(vec)),
                    jmace.edge_harmonics(jnp.asarray(vec))):
        close(a, b)


@pytest.mark.parametrize("correlation", [1, 2, 3])
def test_product_basis_matches_the_reference(correlation):
    rs = np.random.RandomState(correlation)
    a = [rs.randn(7, *s, 5).astype(np.float32) for s in ((), (3,), (3, 3))]
    got = tmace._product_basis(*map(torch.from_numpy, a), correlation)
    want = jmace._product_basis(*map(jnp.asarray, a), correlation)
    for g, w in zip(got, want):
        close(g, w)
    assert got[0].shape[-1] == 5 * tmace._n_basis(correlation)[0]


def test_energy_and_forces_match_the_reference(mol):
    jcfg, tcfg, pj, pt = carried("molecule")
    (pos_j, *rest_j), (pos_t, *rest_t) = mol
    for fn in ("forward", "energy", "forces"):
        want = jax.jit(functools.partial(getattr(jmace, fn), cfg=jcfg))(pj, pos_j, *rest_j)
        close(getattr(tmace, fn)(pt, pos_t, *rest_t, tcfg), want)


def test_node_class_loss_and_gradients_match_the_reference(cora):
    jcfg, tcfg, pj, pt = carried("full_graph_sm")
    bj, bt = cora
    (lj, mj), gj = jax.jit(jax.value_and_grad(lambda p: jmace.node_class_loss(p, bj, jcfg),
                                              has_aux=True))(pj)
    (lt, mt), gt = tloop.value_and_grad(lambda p, b: tmace.node_class_loss(p, b, tcfg), pt, bt)
    close(lt, lj)
    assert float(mt["acc"]) == float(mj["acc"])
    close_trees(gt, gj)
    # mix1/mix2 feed only the rank-1/2 features, which reach no readout
    assert float(gt["mix1"].abs().max()) == 0.0 == float(np.abs(np.asarray(gj["mix1"])).max())
    logits_t = tmace.forward(pt, bt["positions"], bt["species"], bt["senders"], bt["receivers"],
                             tcfg, node_feat=bt["node_feat"])
    logits_j = jmace.forward(pj, bj["positions"], bj["species"], bj["senders"], bj["receivers"],
                             jcfg, node_feat=bj["node_feat"])
    close(logits_t, logits_j)


def test_energy_loss_and_gradients_match_the_reference():
    """Four molecules as one disjoint graph in the port, vmapped one at a
    time in the reference: the same loss and parameter gradients."""
    jcfg, tcfg, pj, pt = carried("molecule")
    pos, spec = jgraphs.molecules(jax.random.PRNGKey(3), 4, 10, n_species=4)
    snd, rcv = jax.vmap(lambda x: jgraphs.knn_edges_from_positions(x, 3))(pos)
    e_ref = np.random.RandomState(0).randn(4).astype(np.float32)
    bj = dict(positions=pos, species=spec, senders=snd, receivers=rcv, energy=jnp.asarray(e_ref))
    bt = {k: torch.from_numpy(np.array(v)) for k, v in bj.items()}
    (lj, mj), gj = jax.jit(jax.value_and_grad(lambda p: jmace.energy_loss(p, bj, jcfg),
                                              has_aux=True))(pj)
    (lt, mt), gt = tloop.value_and_grad(lambda p, b: tmace.energy_loss(p, b, tcfg), pt, bt)
    close(lt, lj)
    close(mt["rmse"], mj["rmse"])
    close_trees(gt, gj)


def test_param_carry_checks_keys_and_shapes():
    jcfg, tcfg, pj, pt = carried("full_graph_sm")
    tree = jax.tree.map(np.asarray, pj)
    back = convert.mace_params_to_numpy(pt)
    assert all(np.array_equal(back[k], tree[k]) for k in tree)
    own = tmace.init_params(torch.Generator().manual_seed(0), tcfg)
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in tree.items()}
    with pytest.raises(ValueError, match="keys"):
        convert.mace_params_from_numpy({k: v for k, v in tree.items() if k != "mix0"}, tcfg)
    with pytest.raises(ValueError, match="shape"):
        convert.mace_params_from_numpy({**tree, "mix0": tree["mix0"][:, :1]}, tcfg)


@pytest.mark.parametrize("shape", ["molecule", "full_graph_sm", "minibatch_lg", "ogb_products"])
def test_configs_equal_the_reference(shape):
    for fn in ("full_config", "smoke_config"):
        assert getattr(tmace_cfg, fn)(shape).__dict__ == getattr(jmace_cfg, fn)(shape).__dict__
    assert (tmace_cfg.ARCH, tmace_cfg.FAMILY, tmace_cfg.SHAPES, tmace_cfg.SKIP) == (
        jmace_cfg.ARCH, jmace_cfg.FAMILY, jmace_cfg.SHAPES, jmace_cfg.SKIP)


# ---------------------------------------------------------------------------
# the reference's properties, on the port
# ---------------------------------------------------------------------------


def rot(axis: int, th: float) -> torch.Tensor:
    c, s = np.cos(th), np.sin(th)
    m = np.eye(3)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    m[i, i] = c; m[i, j] = -s; m[j, i] = s; m[j, j] = c  # noqa: E702
    return torch.from_numpy(m.astype(np.float32))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_energy_rotation_and_translation_invariant(mol, axis):
    _, tcfg, _, pt = carried("molecule")
    pos, spec, snd, rcv = mol[1]
    e1 = float(tmace.energy(pt, pos, spec, snd, rcv, tcfg))
    assert float(tmace.energy(pt, pos @ rot(axis, 0.83).T, spec, snd, rcv, tcfg)) == \
        pytest.approx(e1, rel=1e-4)
    shift = torch.tensor([1.3, -2.0, 0.4])
    assert float(tmace.energy(pt, pos + shift, spec, snd, rcv, tcfg)) == pytest.approx(e1, rel=1e-4)
    assert abs(float(tmace.energy(pt, pos * 1.1, spec, snd, rcv, tcfg)) - e1) > 1e-6


def test_forces_rotation_equivariant(mol):
    _, tcfg, _, pt = carried("molecule")
    pos, spec, snd, rcv = mol[1]
    R = rot(1, 1.1)
    f1 = tmace.forces(pt, pos, spec, snd, rcv, tcfg)
    f2 = tmace.forces(pt, pos @ R.T, spec, snd, rcv, tcfg)
    np.testing.assert_allclose(f2.numpy(), (f1 @ R.T).numpy(), rtol=1e-3, atol=1e-5)
    assert not pos.requires_grad


def test_padded_edges_are_inert(mol):
    _, tcfg, _, pt = carried("molecule")
    pos, spec, snd, rcv = mol[1]
    e_base = float(tmace.energy(pt, pos, spec, snd, rcv, tcfg))
    snd_p = torch.cat([snd, torch.zeros(8, dtype=snd.dtype)])
    rcv_p = torch.cat([rcv, torch.ones(8, dtype=rcv.dtype)])
    mask = torch.cat([torch.ones(snd.shape, dtype=torch.bool), torch.zeros(8, dtype=torch.bool)])
    e_pad = float(tmace.energy(pt, pos, spec, snd_p, rcv_p, tcfg, edge_mask=mask))
    assert e_pad == pytest.approx(e_base, rel=1e-5)


def test_node_mask_zeroes_readout():
    cfg = tmace.MACEConfig(n_layers=1, d_hidden=8, n_rbf=4, n_species=2, d_node_feat=6,
                           n_classes=3, readout_hidden=8)
    p = tmace.init_params(torch.Generator().manual_seed(0), cfg)
    g = tgraphs.random_graph(torch.Generator().manual_seed(1), 20, 60, 6, n_classes=3)
    out = tmace.forward(p, torch.zeros(20, 3), torch.zeros(20, dtype=torch.int32), g.senders,
                        g.receivers, cfg, node_feat=g.features, node_mask=torch.arange(20) < 10)
    assert out.shape == (20, 3) and float(out[10:].abs().max()) == 0.0


def test_node_classification_trains():
    cfg = tmace.MACEConfig(n_layers=2, d_hidden=16, n_rbf=4, n_species=1, d_node_feat=16,
                           n_classes=4, readout_hidden=8)
    params = tmace.init_params(torch.Generator().manual_seed(0), cfg)
    g = tgraphs.random_graph(torch.Generator().manual_seed(1), 80, 400, 16, n_classes=4)
    batch = dict(positions=torch.zeros(80, 3), species=torch.zeros(80, dtype=torch.int32),
                 senders=g.senders, receivers=g.receivers, node_feat=g.features, labels=g.labels)
    ocfg = topt.OptConfig(name="adamw", lr=3e-3)
    opt = topt.init_opt_state(params, ocfg)
    step = tloop.make_train_step(lambda p, b: tmace.node_class_loss(p, b, cfg), ocfg)
    losses = []
    for _ in range(10):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
