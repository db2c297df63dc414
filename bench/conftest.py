"""pytest settings of the benchmark's own tests (``bench/tests``), which
the repository's ``testpaths`` does not collect:

    PYTHONPATH=src python -m pytest -q bench/tests

Tests that need a CUDA card carry the ``chip`` marker and decide inside
the test whether a card is present."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips where there is none")
