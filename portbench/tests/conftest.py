"""The benchmark's tests: on the CPU at small sizes, and marked `cuda`
where they need the card (they skip without one, decided inside the test).

    python -m pytest portbench/tests -q            # here
    python -m pytest portbench/tests -q -m cuda -s # on the card
"""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
