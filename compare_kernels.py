#!/usr/bin/env python3
"""This tree's nest_gemm and fused_chain against earlier sources of the
same two kernels, on one NVIDIA GPU.

    mkdir -p build/old
    git show 69a36e5:src/repro_torch/kernels/csrc/nest_gemm.cu > build/old/nest_gemm.cu
    git show 69a36e5:src/repro_torch/kernels/csrc/fused_chain.cu > build/old/fused_chain.cu
    python3 compare_kernels.py build/old

The earlier sources must have the C interfaces of commit 69a36e5:
``nest_gemm_f32(x, w, o, M, K, N, out_t, act, stream)`` and
``fused_chain_f32`` with one block per M block.  They are built with the
port's nvcc flags.  On the same inputs, for each of ``chip_smoke.py``'s
prefill nest_gemm shapes (M > 8) and each of its fused_chain cases, this
prints whether the two outputs are ``torch.equal`` and both device times
(median [min..max] of the reps, timed as ``chip_smoke.py`` times them).
The earlier kernel is timed between two timings of this tree's kernel.
Exits non-zero if a kernel fails to build or launch, not on a difference.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from repro_torch.configs.feather import feather_config
from repro_torch.kernels import build
from repro_torch.kernels import fused_chain as fc
from repro_torch.kernels import nest_gemm as ng
from repro_torch.runtime import ModelExecutable, ProgramCache

#: the earlier fused_chain's shared-memory limit for its slab
OLD_SMEM_LIMIT = 200 * 1024


class Old:
    """The earlier kernels, built from ``src`` into the build directory."""

    def __init__(self, src: str):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        libs, procs = {}, []
        for name in ("nest_gemm", "fused_chain"):
            libs[name] = os.path.join(build.BUILD_DIR, f"libold_{name}.so")
            procs.append(subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", libs[name],
                 os.path.join(src, f"{name}.cu")]))
        if not all(p.wait() == 0 for p in procs):
            raise RuntimeError(f"the kernels in {src} did not build")
        self.ng = ctypes.CDLL(libs["nest_gemm"]).nest_gemm_f32
        self.ng.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                            + [ctypes.c_void_p])
        self.ng.restype = ctypes.c_int
        self.fc = ctypes.CDLL(libs["fused_chain"]).fused_chain_f32
        self.fc.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int]
                            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p])
        self.fc.restype = ctypes.c_int

    def nest_gemm(self, x, w, *, out_block_t, act):
        m, k = x.shape
        n = w.shape[1]
        out = torch.empty((n, m) if out_block_t else (m, n), device=x.device)
        err = self.ng(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                      int(out_block_t), ng.ACT_CODES[act],
                      build.stream_handle())
        build.raise_on_error(err, "earlier nest_gemm")
        return out

    def fused_chain(self, x, ws, *, bm, bks, acts, adapts, dims):
        n = len(ws)
        bm, n_m, bks, k_slab, n_max = fc.geometry(dims, bm, bks, adapts)
        use_smem = 4 * bm * (k_slab + n_max) <= OLD_SMEM_LIMIT
        m_out, n_out = dims[-1][0], dims[-1][2]
        out = torch.empty((m_out, n_out), device=x.device)
        scratch = torch.empty(0 if use_smem else n_m * bm * (k_slab + n_max),
                              device=x.device)
        flat = [v for d in dims for v in d]
        err = self.fc(
            x.data_ptr(), (ctypes.c_void_p * n)(*[w.data_ptr() for w in ws]),
            (ctypes.c_int * len(flat))(*flat), (ctypes.c_int * n)(*bks),
            (ctypes.c_int * n)(*[fc.ACT_CODES[a] for a in acts]),
            (ctypes.c_int * n)(*[int(bool(a)) for a in adapts]), n,
            out.data_ptr(), scratch.data_ptr() if scratch.numel() else None,
            n_m, bm, k_slab, n_max, m_out, int(use_smem),
            build.stream_handle())
        build.raise_on_error(err, "earlier fused_chain")
        return out


def compare(label, new, old, timer) -> None:
    same = torch.equal(new(), old())
    a, b, c = timer(new), timer(old), timer(new)
    print(f"  {label} | torch.equal {same} | this tree {cs.spread(a)} then "
          f"{cs.spread(c)} | earlier {cs.spread(b)}", flush=True)


def main(argv) -> int:
    if len(argv) != 1:
        print("usage: compare_kernels.py OLD_CSRC_DIR", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card()}", flush=True)
    build.build(("nest_gemm", "fused_chain"))
    old = Old(argv[0])
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()

    cache = ProgramCache()
    fw = [ModelExecutable.for_cell("gemma-7b", cell, feather_config(16, 256),
                                   cache=cache, reduce_model=False)
          for cell in ("decode_tiny", "prefill_tiny")]
    print("nest_gemm, prefill shapes: M K N out_t act", flush=True)
    for m, k, n, out_t, act, *_ in cs.nest_gemm_shapes(*fw, 4):
        if m <= 8:
            continue
        x = torch.randn(m, k, device="cuda", generator=gen)
        w = torch.randn(k, n, device="cuda", generator=gen)
        kw = dict(out_block_t=out_t, act=act)
        compare(f"{m} {k} {n} {out_t} {act}",
                lambda: ng.nest_gemm(x, w, **kw),
                lambda: old.nest_gemm(x, w, **kw), timer)
        del x, w
    torch.cuda.empty_cache()

    rcache = ProgramCache()
    red = [ModelExecutable.for_cell("gemma-7b", cell, feather_config(4, 16),
                                    cache=rcache)
           for cell in ("decode_tiny", "prefill_tiny")]
    print("fused_chain, chip_smoke.py's cases: case (plan)", flush=True)
    for label, dims, bm, bks, acts, adapts in cs.fused_cases(*red, 4):
        x = torch.randn(*dims[0][:2], device="cuda", generator=gen)
        ws = [torch.randn(d[1], d[2], device="cuda", generator=gen)
              for d in dims]
        kw = dict(bm=bm, bks=bks, acts=acts, adapts=adapts, dims=dims)
        p = fc.plan(dims, bm, bks, adapts, acts)
        compare(f"{label} ({p.n_m}x{p.cs} {p.placement})",
                lambda: fc.fused_chain(x, ws, **kw),
                lambda: old.fused_chain(x, ws, **kw), timer)
    print(cs.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
