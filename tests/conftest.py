"""Pytest settings shared by the test files: marker registration only."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device and nvcc; skips on hosts without a card",
    )
