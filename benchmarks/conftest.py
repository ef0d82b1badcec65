"""Tests of the benchmark's harness (benchmarks/tests/), on the CPU.

    python -m pytest benchmarks/tests -q              # CPU; card tests skip
    python -m pytest benchmarks/tests -q -m gpu       # on the card

They import the harness from this directory and the port from the
repository root; nothing here imports JAX.
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for path in (str(HERE), str(HERE.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips without one "
                   "(run on the card: python -m pytest benchmarks/tests -m gpu)")
