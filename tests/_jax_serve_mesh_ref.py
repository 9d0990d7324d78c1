"""The JAX package's sharded serving steps that
``tests/test_torch_serve_mesh.py`` holds the port's mesh serving
against, computed in a process of its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_serve_mesh_ref.py IN.pkl OUT.npz

The flag must be set before JAX is first imported, which a test worker
that has already imported JAX cannot do.  ``IN.pkl`` holds ``cases``
(``[arch, [data, model], extra]``, ``extra`` the config fields replaced
in the reduced fp32 config), and by case id the parameters
(``weights``, the JAX pytree as numpy) and the inputs (``inputs``:
prompts, and a vlm's ``prefix_embeds`` or an encdec model's
``frames``).  Each case is served as ``repro/launch/dryrun.py`` lowers
its steps, on a mesh of those shapes made with ``AxisType.Auto`` axes
and entered with ``jax.set_mesh``: ``jax.jit`` of ``Model.prefill`` with
the parameters at ``tree_shardings(..., inference=True)``, the batch at
``batch_sharding`` and the cache out at ``tree_shardings(cache_axes)``;
the cache padded by the engine's ``expand_cache`` and put at the decode
cache's shardings; then ``STEPS`` greedy ``jax.jit`` decode steps with
those in and out shardings.  ``OUT.npz`` gets, under ``<case id>/``:
``logits/<i>`` (the prefill's, then each step's), ``tokens/<i>``,
``prefill_cache/<path>`` and ``cache/<path>`` (after the last step),
and ``spec/<params|prefill_cache|cache>/<path>`` each leaf's
``PartitionSpec`` as JSON.
"""

import json
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro.configs.base import reduced
from repro.configs.registry import get_config
from repro.dist import sharding as shlib
from repro.models.api import build_model
from repro.serve.engine import expand_cache

B, P, STEPS = 4, 8, 3


def case_id(arch: str, mesh: tuple, extra: tuple) -> str:
    tag = ",".join(f"{k}={v}" for k, v in extra) or "-"
    return f"{arch}|{mesh[0]}x{mesh[1]}|{tag}"


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _flat(tree) -> dict:
    return {_key(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _spec(sharding) -> str:
    return json.dumps([list(e) if isinstance(e, tuple) else e
                       for e in sharding.spec])


def _abstract(tree):
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        tree)


def run_case(arch, mesh_shape, extra, weights, ins, out):
    import dataclasses

    cid = case_id(arch, tuple(mesh_shape), tuple(extra))
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              **{k: v for k, v in extra})
    model = build_model(cfg)
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    batch = {"tokens": ins["prompts"]}
    if "prefix_embeds" in ins:
        batch["patches"] = ins["prefix_embeds"]
    if "frames" in ins:
        batch["frames"] = ins["frames"]
    max_len = P + STEPS + 1 + (cfg.frontend_len if cfg.family == "vlm"
                               else 0)
    with jax.set_mesh(mesh):
        p_shapes = _abstract(weights)
        p_sh = shlib.tree_shardings(model.axes(), p_shapes, mesh,
                                    inference=True)
        b_sh = shlib.batch_sharding(mesh, _abstract(batch))

        def prefill_fn(params, batch):
            return model.prefill(params, batch["tokens"],
                                 prefix_embeds=batch.get("patches"),
                                 frames=batch.get("frames"))
        cache_shapes = jax.eval_shape(prefill_fn, p_shapes,
                                      _abstract(batch))[1]
        c_sh = shlib.tree_shardings(model.cache_axes(), cache_shapes, mesh)
        prefill = jax.jit(prefill_fn, in_shardings=(p_sh, b_sh),
                          out_shardings=(None, c_sh))
        params = jax.device_put(jax.tree.map(jnp.asarray, weights), p_sh)
        logits, cache = prefill(params, batch)
        for path, leaf in _flat(cache).items():
            out[f"{cid}/prefill_cache/{path}"] = np.asarray(leaf)
            out[f"{cid}/spec/prefill_cache/{path}"] = np.asarray(
                _spec(leaf.sharding))
        for path, leaf in _flat(params).items():
            out[f"{cid}/spec/params/{path}"] = np.asarray(
                _spec(leaf.sharding))

        spec = model.cache_spec(B, max_len)
        c_sh = shlib.tree_shardings(model.cache_axes(), spec, mesh)
        d_sh = shlib.batch_sharding(mesh, {
            "tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32),
            "position": jax.ShapeDtypeStruct((B,), jnp.int32)})

        def decode_fn(params, tokens, cache, position):
            return model.decode_step(params, tokens, cache, position)
        decode = jax.jit(decode_fn,
                         in_shardings=(p_sh, d_sh["tokens"], c_sh,
                                       d_sh["position"]),
                         out_shardings=(None, c_sh))
        cache = jax.device_put(expand_cache(model, cache, B, max_len), c_sh)
        tok = jnp.argmax(logits, -1)
        out[f"{cid}/logits/0"] = np.asarray(logits)
        for i in range(STEPS):
            out[f"{cid}/tokens/{i}"] = np.asarray(tok)
            pos = jax.device_put(jnp.full((B,), P + i, jnp.int32),
                                 d_sh["position"])
            tokens = jax.device_put(tok[:, None].astype(jnp.int32),
                                    d_sh["tokens"])
            logits, cache = decode(params, tokens, cache, pos)
            out[f"{cid}/logits/{i + 1}"] = np.asarray(logits)
            tok = jnp.argmax(logits, -1)
        out[f"{cid}/tokens/{STEPS}"] = np.asarray(tok)
        for path, leaf in _flat(cache).items():
            out[f"{cid}/cache/{path}"] = np.asarray(leaf)
            out[f"{cid}/spec/cache/{path}"] = np.asarray(
                _spec(leaf.sharding))


def main(in_path: str, out_path: str) -> None:
    if len(jax.devices()) < 4:
        raise SystemExit("needs 4 host devices: set XLA_FLAGS first")
    with open(in_path, "rb") as f:
        data = pickle.load(f)
    out = {}
    for arch, mesh_shape, extra in data["cases"]:
        cid = case_id(arch, tuple(mesh_shape), tuple(extra))
        run_case(arch, mesh_shape, extra, data["weights"][cid],
                 data["inputs"][cid], out)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
