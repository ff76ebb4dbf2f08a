"""Registers the ``gpu`` marker for runs that collect only this folder."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
