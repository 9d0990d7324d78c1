"""The JAX package's partitioned programs that
``tests/test_torch_dryrun_mesh.py`` holds the port's partitioned trace
against, compiled in a process of its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_dryrun_mesh_ref.py OUT.json

The flag must be set before JAX is first imported, which a test worker
that has already imported JAX cannot do.  Each cell of
``tests/_torch_dryrun_mesh_fns.py`` (reduced gemma-7b and zamba2-1.2b:
train, prefill and decode at 16 tokens and a batch of 4) is lowered as
``repro/launch/dryrun.py`` lowers it, with its in and out shardings, on
a (2, 2) mesh of ``AxisType.Auto`` axes entered with ``jax.set_mesh``,
compiled, and read by ``repro.launch.hlo_analysis.analyze``.
``OUT.json`` gets, by ``<arch>|<kind>``, one device's ``dot_flops`` and
``collectives`` ({kind: bytes}).
"""

import json
import sys

import jax
from jax.sharding import AxisType

from repro.configs.base import ShapeConfig, reduced
from repro.configs.registry import get_config
from repro.dist import sharding as shlib
from repro.launch import hlo_analysis
from repro.models.api import build_model
from repro.train.trainer import TrainConfig, make_train_step, shardings_for

CELLS = [(arch, kind) for arch in ("gemma-7b", "zamba2-1.2b")
         for kind in ("train", "prefill", "decode")]
SEQ, BATCH = 16, 4


def lower(arch: str, kind: str):
    """The cell's step, lowered as the JAX dry run lowers it."""
    model = build_model(reduced(get_config(arch)))
    shape = ShapeConfig(f"{kind}_{SEQ}", SEQ, BATCH, kind)
    batch = model.batch_spec(shape)
    if kind == "train":
        (p_sh, o_sh, b_sh), (p_shapes, o_shapes) = shardings_for(
            model, jax.sharding.get_abstract_mesh(), batch)
        fn = jax.jit(make_train_step(model, TrainConfig()),
                     in_shardings=(p_sh, o_sh, b_sh),
                     out_shardings=(p_sh, o_sh, None))
        return fn.lower(p_shapes, o_shapes, batch)
    mesh = jax.sharding.get_abstract_mesh()
    p_shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    p_sh = shlib.tree_shardings(model.axes(), p_shapes, mesh,
                                inference=True)
    b_sh = shlib.batch_sharding(mesh, batch)
    if kind == "prefill":
        def prefill_fn(params, batch):
            return model.prefill(params, batch["tokens"],
                                 prefix_embeds=batch.get("patches"),
                                 frames=batch.get("frames"))
        cache = jax.eval_shape(prefill_fn, p_shapes, batch)[1]
        c_sh = shlib.tree_shardings(model.cache_axes(), cache, mesh)
        return jax.jit(prefill_fn, in_shardings=(p_sh, b_sh),
                       out_shardings=(None, c_sh)).lower(p_shapes, batch)
    cache = model.cache_spec(BATCH, SEQ)
    c_sh = shlib.tree_shardings(model.cache_axes(), cache, mesh)

    def decode_fn(params, tokens, cache, position):
        return model.decode_step(params, tokens, cache, position)
    return jax.jit(decode_fn, in_shardings=(p_sh, b_sh["tokens"], c_sh,
                                            b_sh["position"]),
                   out_shardings=(None, c_sh)).lower(
        p_shapes, batch["tokens"], cache, batch["position"])


def main(out_path: str) -> None:
    if len(jax.devices()) < 4:
        raise SystemExit("needs 4 host devices: set XLA_FLAGS first")
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    with jax.set_mesh(mesh):
        for arch, kind in CELLS:
            r = hlo_analysis.analyze(lower(arch, kind).compile().as_text())
            out[f"{arch}|{kind}"] = {"dot_flops": r["dot_flops"],
                                     "collectives": r["collectives"]}
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
