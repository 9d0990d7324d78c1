"""The benchmark's files, found by name and held to the benchmark file's
limits; the harness run end to end at tiny sizes on the CPU; the command
refusing to measure without a card."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time

import pytest

from bench import harness
from bench.tests import tiny

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_spec_keys_and_limits():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["bench"]
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for c in SPEC["workloads"]:
        assert c["chips"] in (1, 4) and len(c["why"]) <= 200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    words = [m["name"] for m in METRICS] + [c["name"] for c in
                                            SPEC["workloads"]]
    words += [c["name"] for c in SPEC["configs"]]
    words += [c["traffic"] for c in SPEC["workloads"]]
    words += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(w) for w in words), words
    assert all(UNIT.match(m["unit"]) for m in METRICS)


def test_every_file_is_found_by_name():
    for c in SPEC["workloads"]:
        files = harness.cell_files(c["name"], SPEC)
        doc, traffic = files["doc"], files["traffic"]
        for folder, key in (("adapters", "model_type"),
                            ("reference", "model_type"),
                            ("work", "model_type")):
            assert (ROOT / "bench" / folder / f"{doc[key]}.py").exists()
        for folder in ("runners", "checks"):
            assert (ROOT / "bench" / folder
                    / f"{traffic['kind']}.py").exists()
        assert files["limits"]
    for m in METRICS:
        mod = harness.metric_module(m["name"])
        assert callable(mod.read)
        for op in getattr(mod, "OPS", ()):
            assert (ROOT / "bench" / "work" / "ops" / f"{op}.py").exists()
        assert all(isinstance(v, tuple)
                   for v in getattr(mod, "MODULES", {}).values())


def test_every_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in target or cell in target["workloads"]
    for c in SPEC["workloads"]:
        files = harness.cell_files(c["name"], SPEC)
        assert len(files["end_to_end"]) >= 2 and files["per_layer"]


def top_imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        assert not top_imports(path) & set(harness.FORBIDDEN), path


def test_the_references_import_nothing_of_the_port():
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        assert "repro_torch" not in top_imports(path), path


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models",
                                      "jaxtyping", "bench.harness"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                      "flax.linen"]) == ["flax", "jax",
                                                         "jaxlib", "repro"]


def test_the_command_measures_nothing_without_a_card():
    cell = SPEC["workloads"][0]["name"]
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload", cell,
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no measurement" in proc.stderr


@pytest.mark.parametrize("cell,trace", [(tiny.DECODE, False),
                                        (tiny.PREFILL, True),
                                        (tiny.DECODE, True)])
def test_a_run_end_to_end_at_a_tiny_size(cell, trace):
    files = tiny.files(cell)
    out = harness.measure(files, 2**31 + 101, 0.2, trace, "cpu",
                          time.perf_counter(), lambda line: None)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] and out["attempted"] > 0 and not out["failed"]
    want = {m["name"] for m in files["per_layer" if trace
                                     else "end_to_end"]}
    # the CPU has no device trace: those metrics are left out, never 0
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    assert out["device"]["platform"] == "cpu"
