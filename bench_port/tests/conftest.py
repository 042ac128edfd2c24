"""The benchmark's own tests (run with `python -m pytest bench_port/tests`).
Tests that need a CUDA card carry the `card` marker and skip elsewhere; the
fixture decides, never the import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return "cuda"
