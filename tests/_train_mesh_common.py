"""Helpers shared by ``tests/test_torch_train_mesh*.py``: run the JAX
package's sharded steps (``tests/_jax_train_mesh_ref.py``) in a process
of its own, the port's on gloo ranks (``tests/_torch_train_mesh_fns.py``)
meanwhile, and compare them.  Imports no JAX."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

from _torch_train_mesh_fns import case_id, train, train_cases
from repro_torch.dist import ranks, sharding as sh
from repro_torch.models.common import STACKED

HERE = os.path.dirname(os.path.abspath(__file__))
RTOL = ATOL = 2e-4


def start_reference(cases: list, tmp) -> tuple:
    """Start the JAX reference for ``cases`` on 4 host devices; returns
    (process, output path)."""
    cases_path, out = tmp / "cases.json", tmp / "ref.npz"
    cases_path.write_text(json.dumps(cases))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    src = os.path.join(os.path.dirname(HERE), "src")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_jax_train_mesh_ref.py"),
         str(cases_path), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    return proc, out


def finish_reference(proc, out) -> dict:
    log, _ = proc.communicate(timeout=600)
    if proc.returncode:
        raise RuntimeError(f"the JAX reference failed:\n{log.decode()}")
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def unflatten(flat: dict) -> dict:
    """``{"a/b/0/c": array}`` as nested dicts, a level of digit keys as a
    list (the JAX package's pytree)."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(tree)


def flatten(tree, prefix: str = "") -> dict:
    """The inverse of :func:`unflatten`."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def section(ref: dict, prefix: str) -> dict:
    n = len(prefix)
    return {k[n:]: v for k, v in ref.items() if k.startswith(prefix)}


def run(cases: list, tmp) -> tuple[dict, dict, dict]:
    """(the JAX reference's arrays, the port's mesh runs by case id, its
    runs in one process without a mesh by case id): the reference first
    (it draws the initial weights), then the 4 ranks, then the meshless
    runs here."""
    proc, out = start_reference(cases, tmp)
    try:
        ref = finish_reference(proc, out)
    except BaseException:
        proc.kill()
        raise
    inits = {case_id(*c): unflatten(section(ref, f"{case_id(*c)}/init/"))
             for c in cases}
    mesh = ranks.spawn(train_cases, 4, str(tmp), args=(cases, inits),
                       timeout_s=120, deadline_s=600)[0]
    plain = {case_id(*c): train(c, inits[case_id(*c)]) for c in cases}
    return ref, mesh, plain


def close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def check_case(case, ref: dict, mesh: dict, plain: dict) -> None:
    """The port's mesh run of ``case`` against the JAX package's sharded
    run and against its own meshless run: the batches equal; every step's
    loss, grad_norm and parameters within 2e-4 + 2e-4 * |ref|; every
    parameter's, master's and moment's placements equal to ``placements``
    of the JAX leaf's spec, the stacked ``"layers"`` entry dropped.

    With ``compress_grads`` the parameters are held to the port's own
    step in one process alone.  The int8 round trip rounds g / (amax /
    127), and an element whose gradient lies within the two packages'
    ~1e-6 of a rounding edge lands one int8 step apart; AdamW's first
    steps move every element by about lr whatever its size, so such an
    element's parameter differs by a whole lr step (5e-4 here) between
    the packages, on a mesh or not (``tests/test_torch_substrate.py``'s
    ``test_three_train_steps_match`` says the same of one process)."""
    cid = case_id(*case)
    compress = case[3]
    got, base = mesh[cid], plain[cid]
    for i in range(len(got["loss"])):
        for k, v in got["batches"][i].items():
            np.testing.assert_array_equal(v, ref[f"{cid}/batch/{i}/{k}"])
        for key in ("loss", "grad_norm"):
            close(got[key][i], ref[f"{cid}/step/{i}/{key}"],
                  f"{cid} step {i} {key}")
            close(got[key][i], base[key][i], f"{cid} step {i} {key} (one "
                  f"process)")
        want = section(ref, f"{cid}/step/{i}/params/")
        flat, flat_base = flatten(got["params"][i]), flatten(
            base["params"][i])
        assert set(flat) == set(want) == set(flat_base)
        for path, w in want.items():
            if not compress:
                close(flat[path], w, f"{cid} step {i} {path}")
            close(flat[path], flat_base[path], f"{cid} step {i} {path} "
                  f"(one process)")
    amesh = sh.abstract_mesh(tuple(case[1]), ("data", "model"))
    shapes = {p: a.shape for p, a in section(ref, f"{cid}/init/").items()}
    for group in ("params", "master", "mu", "nu"):
        specs = section(ref, f"{cid}/spec/{group}/")
        placed = got["placements"][group]
        assert len(placed) == sum(
            shapes[p][0] if p.split("/")[0] in STACKED else 1
            for p in specs)
        for name, where in placed.items():
            parts = name.split(".")
            stacked = parts[0] in STACKED
            path = "/".join(parts[:1] + parts[2:] if stacked else parts)
            spec = [tuple(e) if isinstance(e, list) else e
                    for e in json.loads(str(specs[path]))]
            ndim = len(shapes[path])
            if stacked:
                assert spec[:1] in ([], [None]), (path, spec)
                spec, ndim = spec[1:], ndim - 1
            want = str(tuple(sh.placements(tuple(spec), ndim, amesh)))
            assert where == want, (group, name, where, want)
