"""Registers the `cuda` marker of the tests that need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
