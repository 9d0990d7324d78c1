"""Traffic runners, one module a traffic ``kind``: each builds the
port's objects for a configuration, warms up the cell's shapes, drives
the traffic file's load through the port for a measured window, runs a
traced slice of it, and hands what the check compares to ``checks``."""

from __future__ import annotations

import importlib


def for_traffic(traffic: dict):
    """The runner module of a traffic file."""
    return importlib.import_module(f"bench.runners.{traffic['kind']}")
