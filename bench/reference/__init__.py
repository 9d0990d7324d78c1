"""Plain PyTorch references of the configurations, in fp32 (a cell's
check may run their products as TF32: ``bench.checks.serve``), one
module a ``model_type``.  They import nothing of the port and take
nothing it made: the benchmark hands them its own weights (the tensors
it drew from the seed) and the tokens, and they work the rest out again.
Each follows its configuration file's ``departures``: what the port
computes differently from the published model."""

from __future__ import annotations

import importlib


def for_config(doc: dict):
    """The reference module of configuration file ``doc``."""
    return importlib.import_module(f"bench.reference.{doc['model_type']}")
