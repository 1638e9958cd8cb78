"""Settings of the benchmark's own tests. They run on the CPU; a test
that needs the card carries the `cuda` marker and asks the `cuda`
fixture, which skips it where no CUDA device is present (decided when
the test runs, never when a module is imported)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips where none is present)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's eager ops at these sizes run fastest on one intra-op
    thread of the CPU."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
