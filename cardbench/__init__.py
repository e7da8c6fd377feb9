"""The port's benchmark harness (``python3 cardbench/run.py``)."""
