"""Each fault a cell can have, planted under the timed path, turns
``correct`` false: a step that returns its state unchanged, half of the
batch left out (its answers copied from the other half), and an answer
altered where it is produced (each driver's ``plant``, found through
``cardbench.faults`` by the cell's traffic kind).  (One chip: no exchange
to leave out.)"""

import pytest
import torch

from cardbench import faults
from cardbench.reference import checks

from conftest import CELLS, kind


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_makes_the_run_not_correct(run_tiny, cell, fault):
    remove = faults.plant(fault, kind(cell))
    try:
        res = run_tiny(cell)
    finally:
        remove()
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_plant_is_undone(run_tiny, cell):
    faults.plant("unchanged_state", kind(cell))()
    faults.plant("half_batch", kind(cell))()
    assert run_tiny(cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("where", ["inside", "empty"])
def test_an_answer_with_a_hole_makes_the_run_not_correct(run_tiny, monkeypatch, cell, where):
    """A -1 inside an answer, or an answer with no id at all, is counted by
    ``short_answers``, not passed over as a recall miss."""
    import repro_torch.core.brute as brute
    from repro_torch.index.lifecycle import OnlineIndex

    def punch(ids, d):
        ids, d = ids.clone(), d.clone()
        if where == "inside":
            ids[0, 1], d[0, 1] = -1, float("inf")
        else:
            ids[0, :], d[0, :] = -1, float("inf")
        return ids, d

    if kind(cell) == "exact":
        real = brute.brute_force_knn
        monkeypatch.setattr(brute, "brute_force_knn", lambda *a, **kw: punch(*real(*a, **kw)))
    else:
        real_search = OnlineIndex.search

        def faulty(self, *a, **kw):
            res = real_search(self, *a, **kw)
            return res._replace(**dict(zip(("ids", "dists"), punch(res.ids, res.dists))))
        monkeypatch.setattr(OnlineIndex, "search", faulty)
    res = run_tiny(cell)
    assert res["correct"] is False
    c = res["checks"]["short_answers"]
    assert c["value"] > c["limit"]


def test_replanted_exact_fault_keeps_the_running_top_k_and_is_undone(run_tiny):
    """The exact ``unchanged_state`` fault sits at ``ops.tile_topk``, which
    every tile of ``brute_force_knn`` calls: the running best stays empty,
    so every answer is short, and taking the fault out restores the
    operator."""
    import repro_torch.core.brute as brute

    real = brute.ops.tile_topk
    remove = faults.plant("unchanged_state", "exact")
    try:
        assert brute.ops.tile_topk is not real
        res = run_tiny("sift1m.exact10k")
    finally:
        remove()
    assert brute.ops.tile_topk is real
    assert res["correct"] is False
    assert res["checks"]["short_answers"]["value"] == 1.0


@pytest.mark.parametrize("ids, short, holes", [
    ([[1, 2, 3]], 0, 0),
    ([[1, -1, 3]], 1, 1),
    ([[1, 2, -1]], 1, 0),
    ([[-1, -1, -1]], 1, 1),
    ([[-1, 2, 3], [4, 5, 6]], 1, 1),
])
def test_short_rows_and_holes(ids, short, holes):
    t = torch.tensor(ids)
    assert checks.short_rows(t, 3) == short
    assert checks.holes(t) == holes
