"""The benchmark's own tests. Those that need the card carry the ``chip``
marker and take the ``card`` fixture, which skips them where torch sees no
CUDA device; the rest run on the CPU at a tiny size."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA device (skipped without one)")


@pytest.fixture(scope="session", autouse=True)
def _few_threads():
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda:0"
