"""Registers the ``cuda`` marker: tests of the hand-written CUDA kernels
that need an NVIDIA GPU.  They skip (inside a fixture) where there is
none; on a machine with a card run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skipped without one)")
