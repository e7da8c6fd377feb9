"""Faults planted under the timed path, each of which must turn ``correct``
false: a step that returns its state unchanged, half of the batch left out
(its answers copied from the other half), and an answer altered where it is
produced.  (One chip: no exchange between chips to leave out.)

Each driver module plants them under its own timed path
(``cardbench.drivers.<kind>.plant``); ``plant`` finds it by the traffic's
kind.  The CPU tests plant them at a tiny size; ``readings.py --fault``
plants them at a cell's own size on the card, so that the numbers they move
have an upper reading.
"""

from __future__ import annotations

FAULTS = ("unchanged_state", "half_batch", "altered_answer")


def halve(res_ids, res_d):
    """The second half of the batch answered with the first half's answers."""
    h = res_ids.shape[0] // 2
    ids, d = res_ids.clone(), res_d.clone()
    ids[h:2 * h], d[h:2 * h] = res_ids[:h], res_d[:h]
    return ids, d


def alter(res_ids, res_d):
    """One answer of the call moved to a neighbouring row id, its distance
    kept."""
    ids = res_ids.clone()
    a = ids[0, 0]
    ids[0, 0] = a - 1 if a > 0 else a + 1
    return ids, res_d


def swap(obj, name, value, undo):
    """Set ``obj.name`` to ``value``; ``undo`` gains the step that puts the
    old value back."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    undo.append(lambda: setattr(obj, name, old))


def plant(fault: str, kind: str):
    """Plant ``fault`` under the timed path of traffic of kind ``kind``;
    returns the function that takes it out again."""
    from cardbench import harness

    if fault not in FAULTS:
        raise KeyError(f"no fault {fault!r}; known: {FAULTS}")
    undo = []
    harness.driver_module(kind).plant(fault, undo)

    def remove():
        for u in reversed(undo):
            u()
    return remove
