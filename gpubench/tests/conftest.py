"""CPU tests of the harness (``python -m pytest gpubench/tests``). Tests
that need an H100 carry the ``chip`` marker and decide in a fixture."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.cuda.get_device_name(0)
