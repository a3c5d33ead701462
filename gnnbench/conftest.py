"""pytest settings of the benchmark's own tests (gnnbench/tests): the
`chip` marker, for tests that need the card, and the fixture that decides
inside the test whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (skips without one); run on "
        "the card with `python -m pytest -m chip gnnbench/tests`")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures only on the "
                    "card")
    return torch.device("cuda:0")
