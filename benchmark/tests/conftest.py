"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``
from the repository's root. Tests marked ``cuda`` decide inside the test
whether a card is there and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.lib import env  # noqa: E402

env.set_cache_env(ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
