"""pytest settings of the benchmark's tests (gpu_bench/tests/).

Tests marked `card` need an NVIDIA card: the `card` fixture skips them,
deciding at run time, so every worker collects the same tests. On the
card they run with

    python -m pytest gpu_bench/tests -q -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)
