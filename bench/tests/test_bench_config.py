"""The configuration files against their sources: DeepSeek-V2's file
holds every number and nested group of the catalog's entry under the
same key (only the keys in ``reduced`` changed, no width), and it maps
onto the port's registry entry."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from bench import adapters, harness

ROOT = harness.ROOT
D8 = ROOT / "bench/configs/deepseek-v2-236b.d8.json"
CATALOG = ROOT / "bench/configs/sources/deepseek-v2.catalog.jsonl"
#: a width: a hidden, intermediate, latent, state or projection size, a
#: key ending in _dim or _rank, a head size, an expansion factor, or the
#: experts a token
WIDTH = re.compile(r"(_dim|_rank|_size|_width|headdim|_state|_conv|expand"
                   r"|num_experts_per_tok)$")


def spec_entry(name: str) -> dict:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next(c for c in spec["configs"] if c["name"] == name)


def test_catalog_line_is_one_entry():
    lines = CATALOG.read_text().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["name"] == "DeepSeek-V2"
    assert row["config"]["topk_group"] == 3 and row["config"]["n_group"] == 8


def test_d8_holds_every_number_of_its_source():
    row = json.loads(CATALOG.read_text())
    doc = json.loads(D8.read_text())
    entry = spec_entry("deepseek-v2-236b.d8")
    assert entry["source"] == row["source_url"]
    reduced = set(entry["reduced"])
    assert reduced == {"num_hidden_layers", "layers"}
    source = dict(row["config"])
    source.update({k: row[k] for k in row
                   if isinstance(row[k], (int, float, type(None)))
                   and not isinstance(row[k], bool)})
    changed = {k for k, v in source.items() if doc.get(k, "missing") != v}
    assert changed == reduced, changed
    assert doc["num_hidden_layers"] == doc["layers"] == 8
    # nested groups copied whole
    assert doc["rope_scaling"] == row["config"]["rope_scaling"]
    for key in reduced:
        assert doc["reduced"][key]["published"] == source[key]
        assert doc["reduced"][key]["here"] == doc[key]


@pytest.mark.parametrize("entry", json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"],
    ids=lambda c: c["name"])
def test_no_width_is_reduced(entry):
    reduced = entry["reduced"]
    assert not [k for k in reduced if WIDTH.search(k)], reduced
    assert WIDTH.search("moe_intermediate_size")
    assert not WIDTH.search("num_hidden_layers")


def test_d8_departures_name_the_routing():
    doc = json.loads(D8.read_text())
    text = " ".join(doc["departures"])
    for word in ("top-6", "group", "routed_scaling_factor", "capacity",
                 "yarn"):
        assert word in text, word


def registry(arch):
    from repro_torch.configs.registry import get_config
    return get_config(arch)


def differing(a, b) -> dict:
    return {f.name: (getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)
            if getattr(a, f.name) != getattr(b, f.name)}


def test_d8_maps_onto_the_registry_entry_but_depth():
    cfg = adapters.model_config(json.loads(D8.read_text()))
    assert differing(cfg, registry("deepseek-v2-236b")) == {
        "num_layers": (8, 60)}


def test_d8_size_fits_the_card():
    from repro_torch.models.api import build_model

    cfg = adapters.model_config(json.loads(D8.read_text()))
    n = build_model(cfg, device="meta").param_count()
    assert n == 29_191_377_920
    assert n * 2 / 2**30 < 55
