"""The JAX package's multi-device results that ``tests/test_torch_ranks.py``
holds the port's ranks against, computed in a process of its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_jax_mesh_ref.py INPUTS.npz OUT.npz

The flag must be set before JAX is first imported, which a test worker
that has already imported JAX cannot do.  ``INPUTS.npz`` holds
``gemm/<m>x<k>x<n>/<I|W>`` operands and ``grads/<name>`` gradients;
``OUT.npz`` gets ``gemm/<m>x<k>x<n>/<dataflow>/<axis>/<n>`` outputs of
``PallasBackend.run_sharded`` (the ``shard_map`` path, Pallas in
interpret mode) and ``compress/<n>/<name>`` results of
``compressed_dp_allreduce`` over an ``n``-device ``"data"`` mesh, every
device given the same gradients.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro import backends
from repro.configs.feather import feather_config
from repro.core import isa, mapper, program
from repro.dist import ArrayMesh
from repro.dist.compression import compressed_dp_allreduce

CFG = feather_config(4, 16)


def main(inputs: str, out_path: str) -> None:
    if len(jax.devices()) < 4:
        raise SystemExit("needs 4 host devices: set XLA_FLAGS first")
    data = np.load(inputs)
    out = {}
    for key in sorted(k for k in data.files if k.endswith("/I")):
        shape = key.split("/")[1]
        m, k, n = map(int, shape.split("x"))
        t = {"I": data[f"gemm/{shape}/I"], "W": data[f"gemm/{shape}/W"]}
        for df in ("WOS", "IOS"):
            choice = mapper.MappingChoice(
                df=getattr(isa.Dataflow, df), vn=4, m_t=8, k_t=8, n_t=8,
                n_kg=1, n_nb=1, dup=4)
            prog = program.lower(mapper.Gemm(m=m, k=k, n=n), choice, CFG)
            for arrays in (2, 4):
                mesh = ArrayMesh(arrays)
                assert mesh.jax_mesh() is not None
                for axis in ("m", "n", "k"):
                    res = backends.run_sharded(prog, t, mesh,
                                               backend="pallas", axis=axis)
                    out[f"gemm/{shape}/{df}/{axis}/{arrays}"] = np.asarray(
                        res[prog.out_name])
    grads = {k.split("/", 1)[1]: jnp.asarray(data[k])
             for k in data.files if k.startswith("grads/")}
    grads["h"] = grads["h"].astype(jnp.bfloat16)
    for n in (1, 2):
        mesh = jax.make_mesh((n,), ("data",))
        with jax.set_mesh(mesh):
            synced = compressed_dp_allreduce(grads, mesh)
        for name, g in synced.items():
            out[f"compress/{n}/{name}"] = np.asarray(g, np.float32)
            out[f"compress/{n}/{name}/dtype"] = np.asarray(str(g.dtype))
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
