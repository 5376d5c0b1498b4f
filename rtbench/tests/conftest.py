"""Puts the checkout's root on sys.path, so that the tests import rtbench
and the program (tracer_torch) as rtbench/run.py does. rtbench/pytest.ini
makes rtbench the root of these tests, so the repository's own conftest
(which loads JAX for its CPU parity tests) is not loaded here."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def _short_windows(request, monkeypatch):
    """CPU runs of tiny cells complete few frames in their short windows, fewer
    on a loaded machine: keep every 2nd frame for the check, not every 16th.
    The card tests keep the harness's own stride."""
    if request.node.get_closest_marker("card") is None:
        from rtbench import harness, plugins

        monkeypatch.setattr(plugins.load("loops", "frames", harness.ROOT), "SAMPLE_STRIDE", 2)
