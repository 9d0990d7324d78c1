"""Registers the ``cuda`` marker for the benchmark's card tests (as the
repository's ``tests/conftest.py`` does for its own); they decide inside
the test whether a card is present."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")
