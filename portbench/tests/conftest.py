"""Tests of the benchmark harness (not collected by the repository's
tier-1 run, which collects tests/).  Run them from the repository root:

    python -m pytest portbench/tests -q

Tests marked ``card`` need a CUDA card and skip without one; on the
card's machine: ``python -m pytest portbench/tests -q -m card``."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
