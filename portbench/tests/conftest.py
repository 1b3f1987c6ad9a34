"""The benchmark's tests: on the CPU, the port's plain versions stand in
for its kernels; tests marked ``cuda`` run only where a card is.

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.fixture
def bench():
    from portbench import run

    return run


def load(path: Path, name: str):
    from portbench import run

    return run.load_module(path, name)
