"""Faults planted under the timed path, each of which must turn ``correct``
false: a step that returns its state unchanged, half of the batch left out
(its answers copied from the other half), and an answer altered where it is
produced.  (One chip: no exchange between chips to leave out.)

The CPU tests plant them at a tiny size; ``readings.py --fault`` plants
them at a cell's own size on the card, so that the numbers they move have
an upper reading.  ``plant`` returns the function that takes the fault out.
"""

from __future__ import annotations

FAULTS = ("unchanged_state", "half_batch", "altered_answer")


def _halve(res_ids, res_d):
    """The second half of the batch answered with the first half's answers."""
    h = res_ids.shape[0] // 2
    ids, d = res_ids.clone(), res_d.clone()
    ids[h:2 * h], d[h:2 * h] = res_ids[:h], res_d[:h]
    return ids, d


def _alter(res_ids, res_d):
    """One answer of the call moved to a neighbouring row id, its distance
    kept."""
    ids = res_ids.clone()
    a = ids[0, 0]
    ids[0, 0] = a - 1 if a > 0 else a + 1
    return ids, res_d


def _setattr(obj, name, value, undo):
    old = getattr(obj, name)
    setattr(obj, name, value)
    undo.append(lambda: setattr(obj, name, old))


def plant(fault: str, exact: bool):
    """Plant ``fault`` under the exact search (``exact``) or the EHC
    search; returns the function that takes it out again."""
    import repro_torch.core.brute as brute
    import repro_torch.core.search as search
    from repro_torch.index.lifecycle import OnlineIndex

    undo = []
    if fault == "unchanged_state":
        if exact:
            class Ref:  # the running top-k keeps its state
                @staticmethod
                def topk_smallest(d, i, k):
                    return d[:, :k], i[:, :k]
            _setattr(brute, "ref", Ref, undo)
        else:
            _setattr(search, "step", lambda g, x, q, st, cfg, enc=None: st, undo)
    elif fault in ("half_batch", "altered_answer"):
        change = _halve if fault == "half_batch" else _alter
        if exact:
            real = brute.brute_force_knn

            def faulty_brute(*a, **kw):
                return change(*real(*a, **kw))
            _setattr(brute, "brute_force_knn", faulty_brute, undo)
        else:
            real_search = OnlineIndex.search

            def faulty_search(self, *a, **kw):
                res = real_search(self, *a, **kw)
                ids, d = change(res.ids, res.dists)
                return res._replace(ids=ids, dists=d)
            _setattr(OnlineIndex, "search", faulty_search, undo)
    else:
        raise KeyError(f"no fault {fault!r}; known: {FAULTS}")

    def remove():
        for u in reversed(undo):
            u()
    return remove
