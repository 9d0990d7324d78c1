"""Dry run: trace every (arch x shape) cell's step on the ``meta`` device
and reckon its roofline on a production mesh of H100s (counterpart of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k [--multi-pod] [--all] [--json out.jsonl]

The JAX package compiles each cell for 256 or 512 fake host devices and
reads XLA's memory, cost and collective analyses.  Here the model is
built on ``meta`` (no weights exist), and the step runs once under
``graph_analysis.analyze``:

  * train: ``Model.loss``, its backward through the remat, and the AdamW
    update (``train.trainer.make_train_step``);
  * prefill: ``Model.prefill``;
  * decode: one ``Model.decode_step`` against ``cache_spec``.

Nothing is allocated on any device, so it runs on a machine without a
card.  Each record keeps the JAX record's keys where the port has the
quantity:

  * ``flops_global`` and ``tensor_bytes``: the whole step, from the trace;
  * ``flops_per_device``: ``flops_global`` over the mesh's devices, an
    ideal split (no partitioner divides the step);
  * ``bytes_per_device.argument``: parameters, optimizer state, batch and
    (decode) cache, each leaf divided by the sizes of the mesh axes its
    spec names (``dist.sharding``: the training rules for a train cell
    and the cache, the inference rules for a serving cell's weights);
    ``fits_one_card`` holds it against the card's 80 GB;
  * ``t_compute``, ``t_memory``: the per-device flops and bytes over the
    H100's bf16 dense peak and HBM rate, and ``bottleneck`` the larger;
  * ``collective_bytes_per_device``: null -- the port has no partitioner
    to ask.

``long_500k`` cells of full-attention archs SKIP, as in the JAX dry run.
The exit code is 0 only when every cell is OK or SKIP.
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
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.train import optimizer as optlib
from repro_torch.train.trainer import (TrainConfig, make_train_step,
                                       shardings_for)

#: H100 SXM data-sheet rates (roofline denominators): bf16 dense flop/s
#: and HBM bytes/s, and the card's memory
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
CARD_BYTES = 80e9


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


def _step(model, shape, mesh):
    """(the step to trace, its arguments and keyword arguments, the
    argument bytes a device holds by part)."""
    batch = model.batch_spec(shape)
    parts = {"batch": sharded_bytes(
        batch, shlib.batch_sharding(mesh, batch), mesh)}
    if shape.kind == "train":
        (p_sh, o_sh, _), (p_shapes, o_shapes) = shardings_for(model, mesh,
                                                              batch)
        parts.update(params=sharded_bytes(p_shapes, p_sh, mesh),
                     opt=sharded_bytes(o_shapes, o_sh, mesh))
        opt_state = optlib.init(dict(model.net.named_parameters()))
        step = make_train_step(model, TrainConfig())
        return step, (opt_state, batch), {}, parts
    shapes = model.shapes()
    # serving replicates weights over 'data' (no FSDP re-gathers)
    p_sh = shlib.tree_shardings(model.axes(), shapes, mesh, inference=True)
    parts["params"] = sharded_bytes(shapes, p_sh, mesh)
    if shape.kind == "prefill":
        kw = {}
        if "patches" in batch:
            kw["prefix_embeds"] = batch["patches"]
        if "frames" in batch:
            kw["frames"] = batch["frames"]
        return model.prefill, (batch["tokens"],), kw, parts
    cache = model.cache_spec(shape.global_batch, shape.seq_len)
    c_sh = shlib.tree_shardings(model.cache_axes(), cache, mesh)
    parts["cache"] = sharded_bytes(cache, c_sh, mesh)
    return (model.decode_step, (batch["tokens"], cache, batch["position"]),
            {}, parts)


def lower_cell(arch: str, shape_name: str, mesh, verbose: bool = True,
               cfg=None) -> dict:
    """Trace one cell's step on ``meta``; returns its record.  ``cfg``
    (a caller's change of the arch's config, such as a cut depth)
    replaces the registry's."""
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
    n_dev = mesh.size
    flops, nbytes = r["dot_flops"], r["tensor_bytes"]
    argument = sum(parts.values())
    rec = {
        "arch": arch, "shape": shape_name, "status": "OK",
        "mesh": "x".join(str(s) for s in mesh.axis_sizes),
        "devices": n_dev, "trace_s": round(t_trace, 1),
        "ops": r["ops"],
        "flops_global": flops,
        "aten_dot_flops": r["aten_dot_flops"],
        "kernels": r["kernels"],
        "tensor_bytes": nbytes,
        # an ideal split: no partitioner divides the traced step
        "flops_per_device": flops / n_dev,
        "tensor_bytes_per_device": nbytes / n_dev,
        "bytes_per_device": {"argument": argument, **parts},
        "fits_one_card": argument <= CARD_BYTES,
        "collective_bytes_per_device": None,
        "t_compute": flops / n_dev / PEAK_FLOPS,
        "t_memory": nbytes / n_dev / HBM_BW,
    }
    rec["bottleneck"] = max(("t_compute", "t_memory"), key=rec.get)
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
