"""Fused chained GEMM: one CUDA launch for a whole MINISA chained segment.

``fused_chain(x, ws, ...)`` launches ``csrc/fused_chain.cu``:
``act_{L-1}(... act_0(X @ W_0) ... @ W_{L-1})`` with every interior
activation kept on chip (the TPU megakernel it replaces is
``repro/kernels/fused_chain.py``).  Each layer sums its own K tiles of
``bks[l]``, applies its activation at the last tile (elementwise, or
row-wise: softmax, rmsnorm, layernorm), and commits to the slab the next
layer reads.  ``adapts[l]`` lowers the runtime's head-split/merge glue
before layer ``l`` to a static index map on the slab, which needs every
row in one M block.

The M blocks are the TPU kernel's (:func:`geometry`).  Each M block runs
on one thread-block cluster of :func:`cluster_size` blocks, the ranks;
rank ``r`` computes its slice of every layer's columns
(:func:`column_slices`) and shares it with the other ranks through
distributed shared memory.  :func:`plan` lays out a rank's buffers and
says where they live (:data:`PLACEMENTS`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

#: activation name -> the kernel's code
ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "softmax": 4,
             "rmsnorm": 5, "layernorm": 6}
ROW_ACTS = ("softmax", "rmsnorm", "layernorm")

#: shared memory one block may opt into on an H100 (227 KB)
SMEM_LIMIT = 232448
MAX_LAYERS = 16
#: the largest thread-block cluster an H100 runs (16 needs the
#: non-portable opt-in, which the kernel sets)
MAX_CLUSTER = 16
#: at least this many columns of the widest layer per rank
MIN_RANK_COLS = 16

#: where a rank's buffers live, in the order :func:`plan` tries them:
#:   "shared"      slab, rows, accumulator and the rank's weight slices of
#:                 every layer in shared memory (all by cp.async at the
#:                 start);
#:   "shared-slab" the buffers in shared memory and one layer's weight
#:                 slice at a time (the next one's by cp.async while the
#:                 ranks exchange the layer's output);
#:   "global"      every buffer in a global scratch per rank and the
#:                 weights read through L1, for slabs that fit no block
#:                 (tall autotune geometries).
PLACEMENTS = ("shared", "shared-slab", "global")
#: the kernel's weight-stage modes per placement
_STAGE = {"shared": 1, "shared-slab": 2, "global": 0}

#: kernel launches since the count was last set to 0
launches = 0

_FN = None


def _fn():
    global _FN
    if _FN is None:
        fn = build.load("fused_chain").fused_chain_f32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def geometry(dims, bm: int, bks, adapts):
    """The TPU kernel's launch geometry for true per-layer ``dims``:
    (bm, n_m blocks, clamped bks, k_slab, n_max)."""
    bks = tuple(max(1, min(bk, d[1])) for bk, d in zip(bks, dims))
    padded_ks = tuple(-(-d[1] // bk) * bk for d, bk in zip(dims, bks))
    m0 = dims[0][0]
    if any(adapts):
        bm = max(bm, max(d[0] for d in dims))
        n_m = 1
    else:
        bm = max(1, min(bm, m0))
        n_m = -(-m0 // bm)
    k_slab = max(padded_ks[1:] or (1,))
    n_max = max(d[2] for d in dims)
    return bm, n_m, bks, k_slab, n_max


def cluster_size(n_max: int) -> int:
    """Ranks per M block: the power of two that gives the widest layer
    at least :data:`MIN_RANK_COLS` columns a rank, at most
    :data:`MAX_CLUSTER`.  The M block's rows (bm) do not change it; they
    set the buffers :func:`plan` places."""
    cs = 1
    while cs < MAX_CLUSTER and cs * MIN_RANK_COLS < n_max:
        cs *= 2
    return cs


def rank_chunk(n: int, cs: int) -> int:
    """Columns of an ``n``-wide layer per rank: ceil(n / cs) rounded up
    to 4 (the kernel's column group)."""
    return -(-(-(-n // cs)) // 4) * 4


def column_slices(n: int, cs: int) -> list[tuple[int, int]]:
    """Rank r's contiguous columns [c0, c1) of an ``n``-wide layer (empty
    past the last column)."""
    chunk = rank_chunk(n, cs)
    return [(min(n, r * chunk), min(n, (r + 1) * chunk)) for r in range(cs)]


def _ld(width: int) -> int:
    """Row stride in floats: a multiple of 4 (float4 stores), 4 past a
    multiple of 32 so rows start in different banks."""
    return -(-max(width, 1) // 32) * 32 + 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch's layout: ``n_m`` clusters of ``cs`` ranks; per layer
    the columns a rank owns (``chunks``) and its weight-stage offset;
    a rank's buffer is slab (bm x slab_ld), rows (bm x rows_ld, only when
    a layer needs whole rows), accumulator (bm x acc_ld) and the weight
    stage (``stage_floats``: every layer's slice, or the largest one)."""
    bm: int
    n_m: int
    bks: tuple[int, ...]
    cs: int
    chunks: tuple[int, ...]
    w_offs: tuple[int, ...]
    slab_ld: int
    rows_ld: int
    acc_ld: int
    stage_floats: int
    placement: str

    @property
    def buffer_floats(self) -> int:
        """Slab, rows and accumulator of one rank."""
        return self.bm * (self.slab_ld + self.rows_ld + self.acc_ld)

    @property
    def rank_floats(self) -> int:
        return self.buffer_floats + self.stage_floats

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of one block (0 in the global plan)."""
        return 0 if self.placement == "global" else 4 * self.rank_floats

    def ints(self, m_out: int) -> list[int]:
        """The kernel's plan array."""
        slab_off = 0
        rows_off = slab_off + self.bm * self.slab_ld
        acc_off = rows_off + self.bm * self.rows_ld
        wst_off = acc_off + self.bm * self.acc_ld
        return [self.n_m, self.cs, self.bm, m_out, self.slab_ld,
                self.rows_ld, self.acc_ld, slab_off, rows_off, acc_off,
                wst_off, self.rank_floats,
                int(self.placement != "global"), _STAGE[self.placement]]


def plan(dims, bm: int, bks, adapts, acts) -> Plan:
    """The launch plan for true per-layer ``dims``: the TPU geometry's M
    blocks, the cluster, the column slices and the first placement of
    :data:`PLACEMENTS` whose shared memory fits :data:`SMEM_LIMIT`."""
    bm, n_m, bks, k_slab, n_max = geometry(dims, bm, bks, adapts)
    cs = cluster_size(n_max)
    chunks = tuple(rank_chunk(d[2], cs) for d in dims)
    slices = [d[1] * chunk for d, chunk in zip(dims, chunks)]
    n_layers = len(dims)
    gathered = [d[2] for l, d in enumerate(dims)
                if acts[l] in ROW_ACTS
                or (l + 1 < n_layers and adapts[l + 1])]
    base = dict(bm=bm, n_m=n_m, bks=bks, cs=cs, chunks=chunks,
                slab_ld=_ld(max(dims[0][1], k_slab)),
                rows_ld=_ld(max(gathered)) if gathered else 0,
                acc_ld=_ld(max(chunks)))
    stages = {"shared": (tuple(sum(slices[:l]) for l in range(n_layers)),
                         sum(slices)),
              "shared-slab": ((0,) * n_layers, max(slices)),
              "global": ((0,) * n_layers, 0)}
    for where in PLACEMENTS:
        w_offs, stage_floats = stages[where]
        p = Plan(**base, w_offs=w_offs, stage_floats=stage_floats,
                 placement=where)
        if where == "global" or p.smem_bytes <= SMEM_LIMIT:
            return p


@functools.lru_cache(maxsize=256)
def _launch_args(dims, bm, bks, adapts, acts):
    """The plan and the kernel's layer and plan arrays, once per launch
    configuration (hashable arguments)."""
    p = plan(dims, bm, bks, adapts, acts)
    layers = [v for l, d in enumerate(dims)
              for v in (*d, p.bks[l], ACT_CODES[acts[l]], int(adapts[l]),
                        p.chunks[l], p.w_offs[l])]
    ints = p.ints(dims[-1][0])
    return (p, (ctypes.c_int * len(layers))(*layers),
            (ctypes.c_int * len(ints))(*ints))


def placement(dims, bm: int, bks, adapts, acts) -> str:
    """Where the plan of this launch keeps a rank's buffers."""
    return plan(dims, bm, bks, adapts, acts).placement


def fused_chain(x: torch.Tensor, ws, *, bm: int, bks, acts, adapts=None,
                dims=None) -> torch.Tensor:
    """One launch of the chain on the card; returns [m_out, n_out]."""
    global launches
    n_layers = len(ws)
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f"fused_chain takes 1..{MAX_LAYERS} layers, "
                         f"got {n_layers}")
    if adapts is None:
        adapts = (False,) * n_layers
    if dims is None:
        dims = tuple((x.shape[0], w.shape[0], w.shape[1]) for w in ws)
    if not (len(bks) == len(acts) == len(adapts) == len(dims) == n_layers):
        raise ValueError("bks, acts, adapts and dims need one entry per "
                         "layer")
    if adapts[0]:
        raise ValueError("layer 0 reads the host input, not the slab")
    build.check_operand(x, "x", 2)
    if tuple(x.shape) != tuple(dims[0][:2]):
        raise ValueError(f"x is {tuple(x.shape)}, layer 0 expects "
                         f"{tuple(dims[0][:2])}")
    for l, (w, d) in enumerate(zip(ws, dims)):
        build.check_operand(w, f"ws[{l}]", 2)
        if w.device != x.device or tuple(w.shape) != tuple(d[1:]):
            raise ValueError(f"ws[{l}] is {tuple(w.shape)} on {w.device}, "
                             f"expected {tuple(d[1:])} on {x.device}")
        if l and not adapts[l] and d[1] != dims[l - 1][2]:
            raise ValueError(f"chain shape mismatch at layer {l}")
        if acts[l] not in ACT_CODES:
            raise ValueError(f"unknown activation {acts[l]!r}")
    p, layers, ints = _launch_args(
        tuple(tuple(d) for d in dims), bm, tuple(bks),
        tuple(bool(a) for a in adapts), tuple(acts))
    out = torch.empty((dims[-1][0], dims[-1][2]), dtype=torch.float32,
                      device=x.device)
    scratch = (torch.empty(p.n_m * p.cs * p.rank_floats,
                           dtype=torch.float32, device=x.device)
               if p.placement == "global" else None)
    w_ptrs = (ctypes.c_void_p * n_layers)(*[w.data_ptr() for w in ws])
    with torch.cuda.device(x.device):
        err = _fn()(
            x.data_ptr(), w_ptrs, layers, n_layers, ints, out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            build.stream_handle())
    build.raise_on_error(err, "fused_chain")
    launches += 1
    return out
