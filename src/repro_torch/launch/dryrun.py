"""Dry run: trace every (arch x shape) cell's step on the ``meta`` device
and reckon its roofline on a production mesh of H100s (counterpart of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k [--multi-pod] [--all] [--json out.jsonl]

The JAX package compiles each cell for 256 or 512 fake host devices and
reads one device's partitioned program.  Here the model is built on
``meta`` (no weights exist), and the step runs twice under
``graph_analysis.analyze``:

  * train: ``Model.loss``, its backward through the remat, and the AdamW
    update (``train.trainer.make_train_step``);
  * prefill: ``Model.prefill``;
  * decode: one ``Model.decode_step`` against ``cache_spec``.

First the plain step, whole, as one device would run it alone.  Then the
partitioned step: over a fake process group of the mesh's ranks
(``launch.mesh.fake_group``) every leaf is a DTensor of a ``meta`` shard
placed by ``dist.sharding`` -- parameters, optimizer state and batch by
the training rules for a train cell; weights by the inference rules,
batch and cache (``cache_axes``) for a serving cell, as the JAX dry run's
``in_shardings`` place them -- and the step runs on them as on a real
mesh, DTensor's propagation playing the part of XLA's partitioner.
Nothing is allocated on any device and no collective moves data, so it
runs on a machine without a card.  Each record keeps the JAX record's
keys where the port has the quantity:

  * ``flops_global`` and ``tensor_bytes``: the whole step, from the plain
    trace;
  * ``flops_per_device`` and ``tensor_bytes_per_device``: rank 0's share
    of the partitioned step (its local products and traffic, replicated
    work counted on every rank that does it);
  * ``collective_bytes_per_device``: the result bytes of rank 0's
    collectives by kind, their ``total``, and ``by_axis`` (by the mesh
    axis of each collective's group);
  * ``bytes_per_device.argument``: parameters, optimizer state, batch and
    (decode) cache, each leaf divided by the sizes of the mesh axes its
    spec names; ``fits_one_card`` holds it against the card's 80 GB;
  * ``t_compute``, ``t_memory``, ``t_collective``: the per-device flops,
    bytes and collective bytes over the H100's bf16 dense peak, its HBM
    rate and each axis's link rate (:func:`axis_rates`), and
    ``bottleneck`` the largest of the three.

``long_500k`` cells of full-attention archs SKIP, as in the JAX dry run.
A cell whose trace raises is FAIL.  The exit code is 0 only when every
cell is OK or SKIP.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config, get_shape
from repro_torch.dist import sharding as shlib
from repro_torch.launch import graph_analysis
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.train import optimizer as optlib
from repro_torch.train.trainer import (TrainConfig, make_train_step, place,
                                       place_batch, place_cache,
                                       shardings_for)

#: H100 SXM data-sheet rates (roofline denominators): bf16 dense flop/s
#: and HBM bytes/s, and the card's memory
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
CARD_BYTES = 80e9
#: the links of an HGX H100 cluster, data-sheet rates each way a card:
#: NVLink 4 among a node's ``NODE_CARDS`` cards, one 400 Gb/s NDR
#: InfiniBand link across nodes
NVLINK_BW = 450e9
NDR_BW = 50e9
NODE_CARDS = 8


def axis_rates(mesh) -> dict[str, float]:
    """Each mesh axis's link rate, bytes/s a card: the ranks laid out
    row-major over the mesh, ``NODE_CARDS`` consecutive ranks a node, an
    axis whose every group stays inside a node goes at ``NVLINK_BW`` and
    any other at ``NDR_BW``."""
    out = {}
    for i, name in enumerate(mesh.axis_names):
        stride = math.prod(mesh.axis_sizes[i + 1:])
        # a group: the ranks that differ only in this axis's index
        inside = all(
            len({(r + k * stride) // NODE_CARDS
                 for k in range(mesh.axis_sizes[i])}) == 1
            for r in range(mesh.size) if (r // stride) % mesh.axis_sizes[i]
            == 0)
        out[name] = NVLINK_BW if inside else NDR_BW
    return out


def input_specs(arch: str, shape_name: str) -> dict:
    """``meta`` stand-ins for every model input of the cell."""
    shape = get_shape(shape_name)
    model = build_model(get_config(arch), device="meta")
    spec = {"batch": model.batch_spec(shape)}
    if shape.kind == "decode":
        spec["cache"] = model.cache_spec(shape.global_batch, shape.seq_len)
    return spec


def _pairs(tensors, specs):
    """(tensor, spec) at each leaf of a tree of tensors and the tree of
    specs of its structure."""
    if isinstance(tensors, torch.Tensor):
        yield tensors, specs
    elif isinstance(tensors, dict):
        for k, v in tensors.items():
            yield from _pairs(v, specs[k])
    else:
        for t, s in zip(tensors, specs, strict=True):
            yield from _pairs(t, s)


def sharded_bytes(tensors, specs, mesh) -> float:
    """One device's bytes of a tree of tensors laid out by a tree of
    specs of the same structure: each leaf's bytes over the sizes of the
    mesh axes its spec names."""
    sizes = mesh.shape
    total = 0.0
    for t, spec in _pairs(tensors, specs):
        split = math.prod(sizes[a] for entry in spec if entry
                          for a in ((entry,) if isinstance(entry, str)
                                    else entry))
        total += t.numel() * t.element_size() / split
    return total


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


def _step(model, shape, mesh, dmesh=None, make=None):
    """(the step to trace, its arguments and keyword arguments, the
    argument bytes a device holds by part).  With ``dmesh`` (a
    ``DeviceMesh`` of ``mesh``'s axes) every leaf is placed on it first:
    the step is the partitioned one.  ``make`` turns each ``meta`` input
    (batch and cache) into a real tensor, for a step run for real."""
    make = make or (lambda t: t)
    batch = _tree(make, model.batch_spec(shape))
    parts = {"batch": sharded_bytes(
        batch, shlib.batch_sharding(mesh, batch), mesh)}
    if shape.kind == "train":
        (p_sh, o_sh, _), (p_shapes, o_shapes) = shardings_for(model, mesh,
                                                              batch)
        parts.update(params=sharded_bytes(p_shapes, p_sh, mesh),
                     opt=sharded_bytes(o_shapes, o_sh, mesh))
        if dmesh is not None:
            place(model, dmesh)
        opt_state = optlib.init(dict(model.net.named_parameters()))
        step = make_train_step(model, TrainConfig())
        return step, (opt_state, batch), {}, parts
    shapes = model.shapes()
    # serving replicates weights over 'data' (no FSDP re-gathers)
    p_sh = shlib.tree_shardings(model.axes(), shapes, mesh, inference=True)
    parts["params"] = sharded_bytes(shapes, p_sh, mesh)
    if dmesh is not None:
        place(model, dmesh, inference=True)
        batch = place_batch(batch, dmesh)
    if shape.kind == "prefill":
        kw = {}
        if "patches" in batch:
            kw["prefix_embeds"] = batch["patches"]
        if "frames" in batch:
            kw["frames"] = batch["frames"]
        return model.prefill, (batch["tokens"],), kw, parts
    cache = _tree(make, model.cache_spec(shape.global_batch, shape.seq_len))
    c_sh = shlib.tree_shardings(model.cache_axes(), cache, mesh)
    parts["cache"] = sharded_bytes(cache, c_sh, mesh)
    if dmesh is not None:
        cache = place_cache(model, cache, dmesh)
    return (model.decode_step, (batch["tokens"], cache, batch["position"]),
            {}, parts)


def partitioned(cfg, shape, mesh) -> dict:
    """``graph_analysis.analyze`` of the cell's step partitioned over a
    fake process group of ``mesh``'s ranks (rank 0's counts)."""
    with fake_group(mesh) as dmesh:
        model = build_model(cfg, device="meta")
        fn, args, kwargs, _ = _step(model, shape, mesh, dmesh)
        return graph_analysis.analyze(
            fn, *args, axes=graph_analysis.mesh_axes(dmesh), **kwargs)


def lower_cell(arch: str, shape_name: str, mesh, verbose: bool = True,
               cfg=None) -> dict:
    """Trace one cell's step on ``meta``, whole and partitioned over
    ``mesh``; returns its record.  ``cfg`` (a caller's change of the
    arch's config, such as a cut depth) replaces the registry's."""
    cfg = cfg or get_config(arch)
    shape = get_shape(shape_name)
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape_name,
                "status": "SKIP(full-attention)"}
    t0 = time.perf_counter()
    model = build_model(cfg, device="meta")
    fn, args, kwargs, parts = _step(model, shape, mesh)
    r = graph_analysis.analyze(fn, *args, **kwargs)
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = partitioned(cfg, shape, mesh)
    t_part = time.perf_counter() - t0
    argument = sum(parts.values())
    rates = axis_rates(mesh)
    by_axis = {a: sum(k.values()) for a, k in
               sorted(d["collectives_by_axis"].items())}
    rec = {
        "arch": arch, "shape": shape_name, "status": "OK",
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "devices": mesh.size, "trace_s": round(t_trace, 1),
        "partitioned_trace_s": round(t_part, 1),
        "ops": r["ops"],
        "flops_global": r["dot_flops"],
        "aten_dot_flops": r["aten_dot_flops"],
        "kernels": r["kernels"],
        "tensor_bytes": r["tensor_bytes"],
        "ops_per_device": d["ops"],
        "flops_per_device": d["dot_flops"],
        "tensor_bytes_per_device": d["tensor_bytes"],
        "kernels_per_device": d["kernels"],
        "bytes_per_device": {"argument": argument, **parts},
        "fits_one_card": argument <= CARD_BYTES,
        "collective_bytes_per_device": {
            **dict(sorted(d["collectives"].items())),
            "total": d["collective_bytes"], "by_axis": by_axis},
        "link_bw": rates,
        "t_compute": d["dot_flops"] / PEAK_FLOPS,
        "t_memory": d["tensor_bytes"] / HBM_BW,
        # an axis a collective's group names; a group no axis names
        # (none so far) at the slower link
        "t_collective": sum(b / rates.get(a, NDR_BW)
                            for a, b in by_axis.items()),
    }
    rec["bottleneck"] = max(("t_compute", "t_memory", "t_collective"),
                            key=rec.get)
    if verbose:
        print(json.dumps(rec), flush=True)
    return rec


def sweep(cells, mesh, verbose: bool = True) -> list[dict]:
    """:func:`lower_cell` over ``cells`` ((arch, shape) pairs); a cell
    that raises is recorded as FAIL and the sweep goes on."""
    records = []
    for arch, shape in cells:
        try:
            rec = lower_cell(arch, shape, mesh, verbose)
        except Exception as e:  # noqa: BLE001 - report, keep sweeping
            rec = {"arch": arch, "shape": shape,
                   "status": f"FAIL {type(e).__name__}: {e}"}
            print(json.dumps(rec), file=sys.stderr, flush=True)
        records.append(rec)
    return records


def summary(records: list[dict]) -> tuple[int, int, int]:
    """(OK, SKIP, FAIL) counts."""
    ok = sum(1 for r in records if r.get("status") == "OK")
    skip = sum(1 for r in records
               if str(r.get("status", "")).startswith("SKIP"))
    return ok, skip, len(records) - ok - skip


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--json", help="append records to this JSONL file")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])
    records = sweep(cells, mesh)
    if args.json:
        with open(args.json, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    ok, skip, fail = summary(records)
    print(f"\n== dry-run: {ok} OK, {skip} SKIP, {fail} FAIL / "
          f"{len(records)} cells on mesh {mesh.axis_sizes} ==")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
