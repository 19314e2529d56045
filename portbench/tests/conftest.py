"""The benchmark's tests: run from the repository root with
``python -m pytest portbench/tests -q``; tests marked ``gpu`` need the
card and skip without one (on a machine with a CUDA device:
``python -m pytest portbench/tests -m gpu``)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
