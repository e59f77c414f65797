"""The benchmark's tests: on the CPU, except those marked ``card``, which
skip without a CUDA device (decided inside the test)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")
