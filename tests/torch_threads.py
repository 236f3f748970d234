"""A fixture for the test files that run the port's LSTM on the CPU."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The LSTM's products are large enough for PyTorch to spread them over
    its CPU thread pool; with the suite's workers on the same cores, the
    pools' waiting threads slow every worker many times over. One thread
    per worker keeps a file at its single-process speed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
