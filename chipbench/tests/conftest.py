import sys
from pathlib import Path

import pytest

# the program under test, as the benchmark's command finds it in a checkout
_SRC = str(Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.append(_SRC)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one); run on the card"
    )
