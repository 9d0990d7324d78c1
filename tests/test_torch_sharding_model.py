"""The model half of the port's sharding against the JAX package's, with
no devices: for every arch, on both production meshes and under both
rule sets, the spec of every parameter, optimizer-state, batch and cache
leaf equals the JAX package's ``PartitionSpec`` over its
``abstract_mesh`` (shapes from ``jax.eval_shape``).  The port's KV
caches are head-major, so the JAX cache specs are compared after the
same permutation of their ``kvseq`` and ``kv_heads`` dims.  Also
``Model.axes`` leaf for leaf, ``placements`` on hand-written cases, and
the meshes of ``launch.mesh``."""

import functools

import jax
import pytest
import torch
from jax.tree_util import DictKey, SequenceKey, tree_flatten_with_path

from repro.configs.registry import get_config as jget_config
from repro.dist import sharding as jsh
from repro.models import build_model as jbuild_model
from repro.train.trainer import shardings_for as jshardings_for
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.dist import sharding as sh
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build_model
from repro_torch.train.trainer import shardings_for

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
#: the JAX cache axes of a KV leaf, and the port's head-major order
JAX_KV = ("layers", "batch", "kvseq", "kv_heads", "head_dim")
HEAD_MAJOR = (0, 1, 3, 2, 4)


def _key(k) -> str:
    if isinstance(k, DictKey):
        return str(k.key)
    if isinstance(k, SequenceKey):
        return str(k.idx)
    raise TypeError(k)


def jax_leaves(tree, is_leaf=None) -> dict:
    """{path: leaf} of a JAX pytree."""
    return {"/".join(_key(k) for k in path): leaf
            for path, leaf in tree_flatten_with_path(tree,
                                                     is_leaf=is_leaf)[0]}


@functools.cache
def jax_model(arch):
    model = jbuild_model(jget_config(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return model, shapes


@functools.cache
def port_model(arch):
    return build_model(get_config(arch), device="meta")


def specs_of(named_shardings) -> dict:
    return {k: tuple(v.spec) for k, v in jax_leaves(named_shardings).items()}


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def flat_specs(tree, axes_tree=None) -> dict:
    """{path: spec} of a port spec tree, walked along its axes (or
    tensors) tree so a spec tuple is never taken for a container."""
    out = {}

    def walk(spec, ref, path):
        if _is_axes(ref) or isinstance(ref, torch.Tensor):
            out[path] = spec
        elif isinstance(ref, dict):
            for k in ref:
                walk(spec[k], ref[k], f"{path}/{k}" if path else str(k))
        else:
            for i, r in enumerate(ref):
                walk(spec[i], r, f"{path}/{i}" if path else str(i))
    walk(tree, axes_tree, "")
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_and_shapes_equal_the_reference(arch):
    jmodel, jshapes = jax_model(arch)
    model = port_model(arch)
    want = jax_leaves(jmodel.axes(), is_leaf=_is_axes)
    got = flat_specs(model.axes(), model.axes())
    assert got == want
    jshape = {k: tuple(v.shape) for k, v in jax_leaves(jshapes).items()}
    pshape = {k: tuple(t.shape) for k, t in
              flat_specs(model.shapes(), model.shapes()).items()}
    assert pshape == jshape


def head_major(spec: tuple) -> tuple:
    """A JAX KV cache spec in the port's [L, B, KVH, S, D] order."""
    full = list(spec) + [None] * (5 - len(spec))
    out = [full[i] for i in HEAD_MAJOR]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch, mesh_name):
    sizes, names = MESHES[mesh_name]
    jmesh = jsh.abstract_mesh(sizes, names)
    mesh = sh.abstract_mesh(sizes, names)
    jmodel, jshapes = jax_model(arch)
    model = port_model(arch)
    axes, shapes = model.axes(), model.shapes()
    for inference in (False, True):
        want = specs_of(jsh.tree_shardings(jmodel.axes(), jshapes, jmesh,
                                           inference=inference))
        got = flat_specs(sh.tree_shardings(axes, shapes, mesh,
                                           inference=inference), axes)
        assert got == want, inference

    shape = SHAPES["train_4k"]
    (jp, jo, jb), _ = jshardings_for(jmodel, jmesh, jmodel.batch_spec(shape))
    batch = model.batch_spec(shape)
    (p, o, b), (p_shapes, o_shapes) = shardings_for(model, mesh, batch)
    assert flat_specs(p, axes) == specs_of(jp)
    o_axes = {"master": axes, "mu": axes, "nu": axes, "step": ()}
    assert flat_specs(o, o_axes) == specs_of(jo)
    assert flat_specs(b, batch) == specs_of(jb)
    assert all(t.dtype == torch.float32 and t.device.type == "meta"
               for k in ("master", "mu", "nu")
               for t in flat_specs(o_shapes[k], o_shapes[k]).values())

    for name in ("prefill_32k", "decode_32k"):
        shape = SHAPES[name]
        batch = model.batch_spec(shape)
        assert flat_specs(sh.batch_sharding(mesh, batch), batch) == \
            specs_of(jsh.batch_sharding(jmesh, jmodel.batch_spec(shape)))

    jcache = jmodel.cache_spec(shape.global_batch, shape.seq_len)
    jcache_axes = jax_leaves(jmodel.cache_axes(), is_leaf=_is_axes)
    want = {k: head_major(s) if jcache_axes[k] == JAX_KV else s
            for k, s in specs_of(jsh.tree_shardings(
                jmodel.cache_axes(), jcache, jmesh)).items()}
    cache = model.cache_spec(shape.global_batch, shape.seq_len)
    cache_axes = model.cache_axes()
    got = flat_specs(sh.tree_shardings(cache_axes, cache, mesh), cache_axes)
    assert got == want
    head_major_axes = tuple(JAX_KV[i] for i in HEAD_MAJOR)
    assert {k: a for k, a in flat_specs(cache_axes, cache_axes).items()
            if a == head_major_axes}.keys() == \
        {k for k, a in jcache_axes.items() if a == JAX_KV}


@pytest.mark.parametrize("spec,ndim,mesh,want", [
    # the joint batch entry shards dim 0 over both data axes
    ((("pod", "data"), None, "model"), 3,
     ((2, 16, 16), ("pod", "data", "model")),
     ("S0", "S0", "S2")),
    # FSDP: embed over data, ffn over model
    (("data", "model"), 2, ((16, 16), ("data", "model")),
     ("S0", "S1")),
    # replicated everywhere
    ((), 2, ((2, 16, 16), ("pod", "data", "model")),
     ("R",) * 3),
])
def test_placements(spec, ndim, mesh, want):
    from torch.distributed.tensor import Replicate, Shard

    got = sh.placements(spec, ndim, sh.abstract_mesh(*mesh))
    assert got == tuple(Replicate() if w == "R" else Shard(int(w[1:]))
                        for w in want)


def test_placements_refuse_a_foreign_axis_and_too_many_entries():
    mesh = sh.abstract_mesh((16, 16), ("data", "model"))
    with pytest.raises(ValueError, match="not an axis"):
        sh.placements(("pod",), 1, mesh)
    with pytest.raises(ValueError, match="more entries"):
        sh.placements(("data", "model"), 1, mesh)


def test_constraints_are_identities():
    x = torch.randn(4, 8)
    assert sh.constrain_batch(x, ("model",)) is x
    assert sh.constrain_seq_scores(x) is x
    assert sh.constrain_rows_model(x) is x


def test_meshes():
    """The JAX package's shapes (``repro/launch/mesh.py:16-20``), as
    abstract meshes; a real DeviceMesh only over a process group of its
    size."""
    assert meshlib.make_production_mesh().shape == {"data": 16, "model": 16}
    assert meshlib.make_production_mesh(multi_pod=True).shape == \
        {"pod": 2, "data": 16, "model": 16}
    assert meshlib.make_host_mesh("cpu").shape == {"data": 1, "model": 1}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            meshlib.make_host_mesh()
    with pytest.raises(RuntimeError, match="no process group"):
        meshlib.device_mesh(meshlib.make_production_mesh(), "cpu")


def test_device_mesh_over_a_one_rank_group(tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = meshlib.make_host_mesh("cpu")
        dm = meshlib.device_mesh(mesh, "cpu")
        assert dm.mesh_dim_names == ("data", "model")
        x = torch.randn(4, 8)
        spec = sh.spec_for(("batch", "embed"), tuple(x.shape), mesh)
        dt = distribute_tensor(x, dm, sh.placements(spec, 2, mesh))
        assert torch.equal(dt.full_tensor(), x)
        with pytest.raises(RuntimeError, match="ranks"):
            meshlib.device_mesh(meshlib.make_production_mesh(), "cpu")
    finally:
        dist.destroy_process_group()
