"""The port's dry run (``repro_torch.launch.dryrun``) and its analyser
(``launch.graph_analysis``): the abstract inputs against the JAX
package's ``batch_spec``/``cache_spec`` for the cases of
``tests/test_launch.py``; twins of ``tests/test_hlo_analysis.py``'s four
cases; and reduced cells traced on ``meta`` with nothing allocated.

``repro.launch.dryrun`` is not imported: its first lines set
``XLA_FLAGS`` to 512 host devices for every later JAX test of the
worker."""

import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.registry import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs.base import SHAPES, reduced
from repro_torch.configs.registry import cells, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.graph_analysis import analyze
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model

N = 256
KV_HEAD_MAJOR = (0, 1, 3, 2, 4)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ["gemma-7b", "whisper-base",
                                  "internvl2-26b", "falcon-mamba-7b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_input_specs_equal_the_reference(arch, shape_name):
    shape = SHAPES[shape_name]
    spec = dryrun.input_specs(arch, shape_name)
    jmodel = jbuild_model(jget_config(arch))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jmodel.batch_spec(shape).items()}
    got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in spec["batch"].items()}
    assert got == want
    assert all(t.device.type == "meta" for t in _leaves(spec))
    if shape.kind != "decode":
        assert "cache" not in spec
        return
    jcache = list(_leaves(jmodel.cache_spec(shape.global_batch,
                                            shape.seq_len)))
    cache = list(_leaves(spec["cache"]))
    assert len(cache) == len(jcache)
    jaxes = list(_leaves_axes(jmodel.cache_axes()))
    for t, j, ax in zip(cache, jcache, jaxes):
        want_shape = tuple(j.shape)
        if ax == ("layers", "batch", "kvseq", "kv_heads", "head_dim"):
            want_shape = tuple(want_shape[i] for i in KV_HEAD_MAJOR)
        assert (tuple(t.shape), str(t.dtype).removeprefix("torch.")) == \
            (want_shape, str(j.dtype))


def _leaves_axes(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_axes(tree[k])
    elif all(isinstance(a, str) for a in tree):
        yield tree
    else:
        for v in tree:
            yield from _leaves_axes(v)


def test_all_cells_enumerate():
    grid = cells(include_skipped=True)
    assert len(grid) == 40
    skips = [c for c in grid if c[2].startswith("SKIP")]
    assert len(skips) == 8 and all(c[1] == "long_500k" for c in skips)


# ---------------------------------------------------------------------------
# The analyser: twins of tests/test_hlo_analysis.py
# ---------------------------------------------------------------------------

def test_loop_flops_count_every_iteration():
    def f(x, ws):
        for w in ws.unbind(0):
            x = torch.tanh(x @ w)
        return x
    r = analyze(f, torch.randn(N, N), torch.randn(10, N, N))
    assert r["dot_flops"] == pytest.approx(10 * 2 * N ** 3, rel=0.01)


def test_nested_loop_flops_compose():
    def f(x, ws):
        for w in ws.unbind(0):
            for _ in range(3):
                x = torch.tanh(x @ w)
        return x
    r = analyze(f, torch.randn(N, N), torch.randn(10, N, N))
    assert r["dot_flops"] == pytest.approx(30 * 2 * N ** 3, rel=0.01)


def test_unrolled_matches_flop_counter():
    def f(x, w):
        for _ in range(4):
            x = x @ w
        return x
    x, w = torch.randn(N, N), torch.randn(N, N)
    with FlopCounterMode(display=False) as counter:
        f(x, w)
    r = analyze(f, x, w)
    assert r["dot_flops"] == pytest.approx(counter.get_total_flops(),
                                           rel=0.01)


def test_memory_proxy_lower_bounded_by_io():
    r = analyze(torch.matmul, torch.randn(N, N), torch.randn(N, N))
    assert r["tensor_bytes"] >= 0.9 * 3 * N * N * 4
    assert r["collective_bytes"] == 0 and r["collectives"] == {}


def test_meta_trace_matches_the_cpu_trace():
    def f(x, w):
        return torch.relu(x @ w).sum()
    cpu = analyze(f, torch.randn(64, 32), torch.randn(32, 16))
    meta = analyze(f, torch.empty(64, 32, device="meta"),
                   torch.empty(32, 16, device="meta"))
    assert (meta["dot_flops"], meta["tensor_bytes"], meta["ops"]) == \
        (cpu["dot_flops"], cpu["tensor_bytes"], cpu["ops"])


# ---------------------------------------------------------------------------
# Cells traced on meta
# ---------------------------------------------------------------------------

class _Devices(TorchDispatchMode):
    """The devices of every tensor any dispatched op returned, less the
    fake tensors (no storage) DTensor's sharding propagation makes on
    the mesh's device type to learn its outputs' shapes."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _leaves(out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor) and not isinstance(t, FakeTensor):
                self.seen.add(t.device.type)
        return out


def test_dense_train_cell_on_meta():
    cfg = reduced(get_config("gemma-7b"), layers=2, d_model=64, vocab=256)
    mesh = make_production_mesh()
    with _Devices() as devices:
        rec = dryrun.lower_cell("gemma-7b", "train_4k", mesh, verbose=False,
                                cfg=cfg)
    assert devices.seen == {"meta"}
    assert rec["status"] == "OK" and rec["devices"] == 256
    # the forward, the remat's recompute and the backward of each layer
    assert rec["kernels"]["flash_attention"]["calls"] == 2 * cfg.num_layers
    assert rec["kernels"]["flash_attention_bwd"]["calls"] == cfg.num_layers
    params = build_model(cfg, device="meta").param_count()
    tokens = SHAPES["train_4k"].global_batch * SHAPES["train_4k"].seq_len
    assert rec["flops_global"] > 6 * params * tokens
    # partitioned: rank 0's share, at least an even split of the whole
    # (4 heads and a 256 vocabulary cannot split 16 ways, so much of it
    # is replicated over "model")
    assert rec["flops_global"] / 256 <= rec["flops_per_device"] \
        < rec["flops_global"]
    b = rec["bytes_per_device"]
    assert b["argument"] == b["params"] + b["opt"] + b["batch"]
    # bf16 weights, fp32 master and moments, each split as its spec says
    assert b["opt"] > 3 * b["params"] and rec["fits_one_card"]
    coll = rec["collective_bytes_per_device"]
    assert coll["total"] == sum(v for k, v in coll.items()
                                if k not in ("total", "by_axis"))
    assert coll["total"] == sum(coll["by_axis"].values()) > 0
    assert set(coll["by_axis"]) == {"data", "model"}
    assert rec["t_collective"] == sum(
        v / rec["link_bw"][a] for a, v in coll["by_axis"].items())
    assert rec["bottleneck"] == max(
        ("t_compute", "t_memory", "t_collective"), key=rec.get)


def test_hybrid_decode_cell_on_meta():
    cfg = reduced(get_config("zamba2-1.2b"), layers=7, d_model=64,
                  vocab=256)
    mesh = make_production_mesh(multi_pod=True)
    with _Devices() as devices:
        rec = dryrun.lower_cell("zamba2-1.2b", "decode_32k", mesh,
                                verbose=False, cfg=cfg)
    assert devices.seen == {"meta"}
    assert rec["status"] == "OK" and rec["mesh"] == "2x16x16"
    assert rec["kernels"]["mamba_scan"]["calls"] == cfg.num_layers
    assert rec["kernels"]["flash_decode"]["calls"] == \
        cfg.num_layers // cfg.attn_every
    assert "cache" in rec["bytes_per_device"]
    # 4 KV heads cannot take the 16-way "model" axis: the cache is cut
    # along its sequence there and gathered before flash_decode
    assert rec["collective_bytes_per_device"]["by_axis"]["model"] > 0
    assert rec["bottleneck"] == "t_collective"


def test_main_skips_full_attention_at_500k(capsys):
    assert dryrun.main(["--arch", "whisper-base", "--shape",
                        "long_500k"]) == 0
    assert "0 OK, 1 SKIP, 0 FAIL / 1 cells" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-72b", "qwen1.5-110b",
                                  "minitron-4b"])
def test_dense_prefill_products_equal_model_gemms(arch):
    """A dense prefill cell at full size: the products the trace counts
    outside the kernel ops equal ``core.model_gemms``' non-dynamic GEMMs
    (the projections, the MLP and the head over every position; the
    score and value products are the kernel's), flop for flop."""
    from repro_torch.core.model_gemms import gemm_workloads

    rec = dryrun.lower_cell(arch, "prefill_32k", make_production_mesh(),
                            verbose=False)
    want = sum(2 * op.gemm.m * op.gemm.k * op.gemm.n * op.gemm.count
               for op in gemm_workloads(get_config(arch),
                                        SHAPES["prefill_32k"])
               if not op.dynamic)
    assert rec["aten_dot_flops"] == want
    assert rec["kernels"]["flash_attention"]["calls"] == \
        get_config(arch).num_layers


def test_functional_collectives_are_counted(tmp_path):
    """An all-reduce and an all-gather on a one-rank gloo group: their
    result bytes, by kind (the twin of the HLO analyser's collective
    bytes)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fcol

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        def f(x):
            y = fcol.all_reduce(x, "sum", dist.group.WORLD)
            return fcol.all_gather_single(y, 0, dist.group.WORLD) * 2
        r = analyze(f, torch.ones(4, 8))
    finally:
        dist.destroy_process_group()
    assert r["collectives"] == {"all_reduce": 128.0,
                                "all_gather_into_tensor": 128.0}
    assert r["collective_bytes"] == 256.0


def test_kernel_ops_on_meta_match_the_plain_versions():
    """Each kernel op (and the backwards of the two that carry gradients)
    on ``meta`` gives the plain version's shapes and dtypes, and reckons
    its flops as ``chip_smoke.py`` reckons the kernel's bound."""
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)

    def pair(*shape, dtype=torch.float32):
        t = torch.randn(shape, generator=g).to(dtype)
        return t, torch.empty(shape, dtype=dtype, device="meta")

    def run(fn, *tensors):
        """fn's outputs and input gradients on the CPU and on meta."""
        outs = []
        for ts in zip(*tensors):
            ts = [t.requires_grad_() for t in ts]
            out = fn(*ts)
            out = out if isinstance(out, tuple) else (out,)
            sum(o.float().sum() for o in out).backward()
            outs.append([(tuple(o.shape), o.dtype) for o in out]
                        + [(tuple(t.grad.shape), t.grad.dtype) for t in ts])
        return outs

    qkv = [pair(2, 40, 3, 16, dtype=torch.bfloat16) for _ in range(3)]
    scan = [pair(2, 20, 8, 5), pair(2, 20, 8, 5), pair(2, 20, 5),
            pair(2, 8, 5)]
    for fn, tensors in ((ops.flash_attention, qkv), (ops.mamba_scan, scan)):
        cpu, meta = run(fn, *tensors)
        assert cpu == meta, fn
    q, k, v = (pair(4, 2, 16)[1], pair(4, 9, 16)[1], pair(4, 9, 16)[1])
    r = analyze(ops.flash_decode, q, k, v)
    assert r["kernels"]["flash_decode"] == {
        "calls": 1, "flops": 4.0 * 4 * 2 * 9 * 16,
        "bytes": 4.0 * (2 * 4 * 9 * 16 + 2 * 4 * 2 * 16)}
    r = analyze(ops.mamba_scan, *(t for _, t in scan))
    # N 5 is padded to the kernel's 8
    assert r["kernels"]["mamba_scan"]["flops"] == 4.0 * 2 * 20 * 8 * 8
    r = analyze(ops.flash_attention, *(t for _, t in qkv))
    # 40 tokens padded to blocks of 32: 64 query rows, 40 keys
    assert r["kernels"]["flash_attention"]["flops"] == \
        2.0 * 6 * (40 * 41 // 2 + 24 * 40) * 32
