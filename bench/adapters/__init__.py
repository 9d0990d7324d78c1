"""A configuration file's keys mapped onto the port's ``ModelConfig``,
one module a ``model_type`` (the source config's own key)."""

from __future__ import annotations

import importlib


def model_config(doc: dict):
    """The port's ``ModelConfig`` for the configuration file ``doc``."""
    mod = importlib.import_module(f"bench.adapters.{doc['model_type']}")
    return mod.model_config(doc)
