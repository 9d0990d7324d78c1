"""The JAX package's sharded train steps that ``tests/test_torch_train_mesh*.py``
hold the port's mesh step against, computed in a process of its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_train_mesh_ref.py CASES.json OUT.npz

The flag must be set before JAX is first imported, which a test worker
that has already imported JAX cannot do.  ``CASES.json`` is a list of
``[arch, [data, model], grad_accum, compress_grads]``.  For each case the
reduced config of ``arch`` (fp32) is initialised from ``PRNGKey(0)`` and
trained ``STEPS`` steps on ``SyntheticLM`` batches of ``BATCH`` x
``SEQ`` by ``jax.jit(make_train_step(...), in_shardings, out_shardings)``
over ``shardings_for``'s shardings on a mesh of those shapes.  The mesh
is made with ``AxisType.Auto`` axes and entered with ``jax.set_mesh``:
the launcher's own ``make_host_mesh`` makes ``Explicit`` axes under jax
0.9, where ``constrain_rows_model`` raises.  ``OUT.npz`` gets, under
``<case id>/``: ``init/<path>`` the initial parameters, ``batch/<i>/<key>``
the batches, ``step/<i>/loss`` and ``grad_norm``, ``step/<i>/params/<path>``
the parameters after each step, and ``spec/<params|master|mu|nu>/<path>``
each leaf's ``PartitionSpec`` as JSON.
"""

import json
import sys

import jax
import numpy as np
from jax.sharding import AxisType

from repro.configs.base import ShapeConfig, reduced
from repro.configs.registry import get_config
from repro.data.pipeline import DataConfig, SyntheticLM
from repro.models.api import build_model
from repro.train import optimizer as optlib
from repro.train.trainer import TrainConfig, make_train_step, shardings_for

STEPS = 2
BATCH, SEQ = 4, 16
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def case_id(arch: str, mesh: tuple, accum: int, compress: bool) -> str:
    return f"{arch}|{mesh[0]}x{mesh[1]}|{accum}|{int(compress)}"


def _key(path) -> str:
    parts = []
    for k in path:
        parts.append(str(getattr(k, "key", getattr(k, "idx", k))))
    return "/".join(parts)


def _flat(tree) -> dict:
    return {_key(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _spec(sharding) -> str:
    return json.dumps([list(e) if isinstance(e, tuple) else e
                       for e in sharding.spec])


def run_case(arch, mesh_shape, accum, compress, out):
    cid = case_id(arch, mesh_shape, accum, compress)
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size), cfg,
                       ShapeConfig("t", SEQ, BATCH, "train"))
    batches = [data.batch(i) for i in range(STEPS)]
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tcfg = TrainConfig(opt=optlib.OptimizerConfig(**OPT), grad_accum=accum,
                       compress_grads=compress)
    with jax.set_mesh(mesh):
        spec = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            batches[0])
        (p_sh, o_sh, b_sh), _ = shardings_for(model, mesh, spec)
        step = jax.jit(make_train_step(model, tcfg),
                       in_shardings=(p_sh, o_sh, b_sh),
                       out_shardings=(p_sh, o_sh, None))
        params = model.init(jax.random.PRNGKey(0))
        for path, leaf in _flat(params).items():
            out[f"{cid}/init/{path}"] = np.asarray(leaf)
        params = jax.device_put(params, p_sh)
        opt_state = jax.device_put(optlib.init(params), o_sh)
        for i, batch in enumerate(batches):
            for k, v in batch.items():
                out[f"{cid}/batch/{i}/{k}"] = v
            params, opt_state, metrics = step(params, opt_state, batch)
            out[f"{cid}/step/{i}/loss"] = np.asarray(metrics["loss"])
            out[f"{cid}/step/{i}/grad_norm"] = np.asarray(
                metrics["grad_norm"])
            for path, leaf in _flat(params).items():
                out[f"{cid}/step/{i}/params/{path}"] = np.asarray(leaf)
        for path, leaf in _flat(params).items():
            out[f"{cid}/spec/params/{path}"] = np.asarray(_spec(leaf.sharding))
        for k in ("master", "mu", "nu"):
            for path, leaf in _flat(opt_state[k]).items():
                out[f"{cid}/spec/{k}/{path}"] = np.asarray(
                    _spec(leaf.sharding))


def main(cases_path: str, out_path: str) -> None:
    if len(jax.devices()) < 4:
        raise SystemExit("needs 4 host devices: set XLA_FLAGS first")
    with open(cases_path) as f:
        cases = json.load(f)
    out = {}
    for arch, mesh_shape, accum, compress in cases:
        run_case(arch, tuple(mesh_shape), accum, compress, out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
