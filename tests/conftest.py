"""Registers the marker for tests that need an NVIDIA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc; skipped where torch.cuda is unavailable",
    )
