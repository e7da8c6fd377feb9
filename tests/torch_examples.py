"""Shared helpers of the example parity tests (``tests/test_torch_examples.py``,
``test_torch_example_lifecycle.py``, ``test_torch_example_parallel.py``):
loading an example by name and the two comparison tiers."""

import importlib.util
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# recall on real-valued rows: the packages round distances differently (XLA
# and torch sum in their own orders), so near-ties may resolve differently
RECALL_TOL = 0.02


def load(name):
    """The module of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close(got, want, exact, err):
    """A recall of the port against the reference's: equal as float32 on
    integer rows (``exact``), within ``RECALL_TOL`` on real-valued rows."""
    if exact:  # the same hits over the same count, in each package's float
        assert np.float32(got) == np.float32(want), f"{err}: {got} vs {want}"
    else:
        assert abs(got - want) <= RECALL_TOL, f"{err}: {got} vs {want}"


