"""What decides ``correct``: one module a traffic ``kind``, each
comparing what the timed path produced with the configuration's plain
reference (``bench.reference``), once the window has closed and the
program's state is freed.  ``compare`` returns the numbers compared,
each with its limit (the cell's ``bench/workloads/<cell>.json``)."""

from __future__ import annotations

import importlib


def for_traffic(traffic: dict):
    return importlib.import_module(f"bench.checks.{traffic['kind']}")
