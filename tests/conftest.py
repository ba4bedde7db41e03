"""Pytest settings shared by the test suite: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc (the port's CUDA kernels); "
        "skipped where torch.cuda.is_available() is false")
