"""Helpers shared by ``tests/test_torch_serve_mesh*.py``: the JAX
package's sharded serving steps (``tests/_jax_serve_mesh_ref.py``) in a
process of its own, the port's on 4 gloo ranks
(``tests/_torch_serve_mesh_fns.py``) meanwhile, from the same seeded
weights, and the comparison of the two.  Imports no JAX."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import torch

from _torch_serve_mesh_fns import (STEPS, case_id, config, inputs,
                                   serve_cases)
from repro_torch.dist import ranks, sharding as sh
from repro_torch.models.api import build_model
from repro_torch.models.common import STACKED

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL = ATOL = 2e-4


def cid_of(case) -> str:
    return case_id(case[0], tuple(case[1]), tuple(case[2]))


def _weights(arch, extra):
    """Seeded weights of the reduced config, drawn by the port (in
    milliseconds, where the JAX package's eager init takes seconds a
    model) and given to both packages as the JAX pytree of numpy
    arrays."""
    model = build_model(config(arch, tuple(extra)), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return model.numpy_tree()


def run(cases: list, tmp) -> tuple[dict, list]:
    """(the JAX reference's arrays, the ranks' results in rank order)
    for ``cases``; the two run at once."""
    weights, ins, made = {}, {}, {}
    for arch, _, extra in cases:
        key = (arch, tuple(extra))
        if key not in made:
            made[key] = _weights(arch, extra)
        weights[cid_of([arch, _, extra])] = made[key]
        ins[cid_of([arch, _, extra])] = inputs(config(arch, tuple(extra)))
    in_path, out = tmp / "in.pkl", tmp / "ref.npz"
    with open(in_path, "wb") as f:
        pickle.dump({"cases": cases, "weights": weights, "inputs": ins}, f)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(os.path.dirname(HERE), "src"),
                    env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_jax_serve_mesh_ref.py"),
         str(in_path), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        mesh = ranks.spawn(serve_cases, 4, str(tmp),
                           args=(cases, weights, ins), timeout_s=120,
                           deadline_s=600)
        log, _ = proc.communicate(timeout=600)
    except BaseException:
        proc.kill()
        raise
    if proc.returncode:
        raise RuntimeError(f"the JAX reference failed:\n{log.decode()}")
    with np.load(out) as data:
        ref = {k: data[k] for k in data.files}
    return ref, mesh


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _section(ref, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix)}


def _spec(text):
    return [tuple(e) if isinstance(e, list) else e for e in json.loads(
        str(text))]


def _head_major(path, ndim):
    """Whether the port's cache leaf at ``path`` is a head-major KV cache
    ([L, B, KVH, S, D]; the JAX package's [L, B, S, KVH, D])."""
    return ndim == 5 and "ssm" not in path


def check_case(case, ref: dict, mesh: list) -> None:
    """Rank 0's serve of ``case`` against the JAX reference's: logits and
    every cache leaf within 2e-4 + 2e-4 * |ref|, every rank's greedy
    tokens equal to the reference's, every parameter's and cache leaf's
    placements equal to the JAX spec's."""
    cid = cid_of(case)
    got = mesh[0][cid]
    for i, logits in enumerate(got["logits"]):
        _close(logits, ref[f"{cid}/logits/{i}"], f"{cid} logits {i}")
    want = [ref[f"{cid}/tokens/{i}"] for i in range(STEPS + 1)]
    for rank in range(4):
        np.testing.assert_array_equal(
            np.asarray(mesh[rank][cid]["tokens"], np.int64),
            np.asarray(want, np.int64), err_msg=f"{cid} rank {rank}")
    amesh = sh.abstract_mesh(tuple(case[1]), ("data", "model"))
    for stage in ("prefill_cache", "cache"):
        values = _section(ref, f"{cid}/{stage}/")
        specs = _section(ref, f"{cid}/spec/{stage}/")
        where = got["prefill_placements" if stage == "prefill_cache"
                    else "placements"]
        assert set(got[stage]) == set(values) == set(where)
        for path, want_v in values.items():
            v = got[stage][path]
            spec = _spec(specs[path])
            if _head_major(path, v.ndim):
                v = v.transpose(0, 1, 3, 2, 4)
                spec += [None] * (5 - len(spec))
                spec[2], spec[3] = spec[3], spec[2]
            _close(v, want_v, f"{cid} {stage} {path}")
            assert where[path] == str(sh.placements(tuple(spec), 8,
                                                    amesh)), \
                (cid, stage, path, where[path], spec)
    specs = _section(ref, f"{cid}/spec/params/")
    for name, where in got["param_placements"].items():
        parts = name.split(".")
        stacked = parts[0] in STACKED
        path = "/".join(parts[:1] + parts[2:] if stacked else parts)
        spec = _spec(specs[path])
        if stacked:
            assert spec[:1] in ([], [None]), (path, spec)
            spec = spec[1:]
        want_p = str(sh.placements(tuple(spec), 8, amesh))
        assert where == want_p, (cid, name, where, want_p)
