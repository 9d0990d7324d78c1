#!/usr/bin/env python3
"""This tree's kernels against earlier sources of the same kernels, on one
NVIDIA GPU.

    mkdir -p build/old
    git show 69a36e5:src/repro_torch/kernels/csrc/nest_gemm.cu > build/old/nest_gemm.cu
    git show 69a36e5:src/repro_torch/kernels/csrc/fused_chain.cu > build/old/fused_chain.cu
    git show 273c856:src/repro_torch/kernels/csrc/flash_attention.cu > build/old/flash_attention.cu
    git show cd9a6cc:src/repro_torch/kernels/csrc/flash_decode.cu > build/old/flash_decode.cu
    git show bac22f7:src/repro_torch/kernels/csrc/flash_decode_proj.cu > build/old/flash_decode_proj.cu
    git show f0798b2:src/repro_torch/kernels/csrc/flash_attention_bwd.cu > build/old/flash_attention_bwd.cu
    git show f0798b2:src/repro_torch/kernels/csrc/mamba_scan_bwd.cu > build/old/mamba_scan_bwd.cu
    python3 compare_kernels.py build/old

Each kernel whose source the directory holds is compared; an earlier
source must have the C interface of the commit named above:
``nest_gemm_f32(x, w, o, M, K, N, out_t, act, stream)`` and
``fused_chain_f32`` with one block per M block (commit 69a36e5);
``flash_attention_fwd`` without the lse pointer it took later (commits
273c856 to 6eaa34c);
``flash_decode_f32`` as it is now (commit bac22f7, the kernel before its
bf16 route, or later) and, where the earlier source has it,
``flash_decode_bf16`` as it is now (commit cd9a6cc, the bf16 route as a
template of the fp32 kernel, before its redesign);
``flash_decode_proj_f32`` as it is now (commit bac22f7);
``flash_attention_bwd`` as it is now (commit f0798b2, FFMA from shared
memory); ``mamba_scan_bwd_f32`` taking h0 and a checkpoint scratch, which
it fills by replaying the scan (commit f0798b2).  They are built with the
port's nvcc flags.  On the same inputs, for each of
``chip_smoke.py``'s prefill nest_gemm shapes (M > 8) and fused_chain
cases, this prints whether the two outputs are ``torch.equal``; for
flash_attention at ``chip_smoke.py``'s shape (fp32 and bf16),
flash_decode at its case and the serves' shapes (and, with an earlier
bf16 route, at ``chip_smoke.py``'s three bf16 rows at their check()
tolerance), and flash_decode_proj
at ``chip_smoke.py``'s K4 case (full-width gemma-7b's attention segment
at 4 requests, wo 4096 x 3072), whose sum orders changed, whether they
are ``torch.equal`` and ``torch.allclose`` at ``check()``'s tolerance (fp32: rtol 2e-4, atol
2e-4 * d, or 2e-4 * k_out for the projection; bf16 outputs: rtol 2e-2,
atol 2e-1, the card tests') and their largest difference; the same for
flash_attention_bwd's (dq, dk, dv) at ``chip_smoke.TRAIN_ATTN_CASE``
(fp32 and bf16), and for mamba_scan_bwd's (dda, ddbx, dc, dh0) at
``chip_smoke.TRAIN_SCAN_SHAPE``, this tree's given the forward's states
(as training calls it; the forward is not timed).  Both device times
follow (median [min..max] of the reps, timed as ``chip_smoke.py`` times
them); the earlier kernel is timed between two timings of this tree's.
flash_decode_proj is timed once more as a probe, with L2 cleared by
reading 256 MB in place of ``chip_smoke.py``'s write (``ReadFlush``): the
write leaves up to 50 MB of dirty lines, whose write-back a kernel that
streams 50 MB waits for; the difference is that wait.  flash_decode's
fp32 output digests at ``chip_smoke.DIGEST_CASES`` follow, for both
kernels: the values ``chip_smoke.DECODE_F32_DIGESTS`` records.
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_chain as fc
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import nest_gemm as ng
from repro_torch.runtime import ModelExecutable, ProgramCache

#: the earlier fused_chain's shared-memory limit for its slab
OLD_SMEM_LIMIT = 200 * 1024


#: the kernels this script can compare, by source name
NAMES = ("nest_gemm", "fused_chain", "flash_attention", "flash_decode",
         "flash_decode_proj", "flash_attention_bwd", "mamba_scan_bwd")


class Old:
    """The earlier kernels whose sources ``src`` holds, built into the build
    directory; ``names`` lists them."""

    def __init__(self, src: str):
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        self.names = [n for n in NAMES
                      if os.path.exists(os.path.join(src, f"{n}.cu"))]
        libs, procs = {}, []
        for name in self.names:
            libs[name] = os.path.join(build.BUILD_DIR, f"libold_{name}.so")
            procs.append(subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", libs[name],
                 os.path.join(src, f"{name}.cu")], stdout=subprocess.DEVNULL))
        if not all(p.wait() == 0 for p in procs):
            raise RuntimeError(f"the kernels in {src} did not build")
        fns = {n: getattr(ctypes.CDLL(libs[n]), sym) for n, sym in (
            ("nest_gemm", "nest_gemm_f32"), ("fused_chain", "fused_chain_f32"),
            ("flash_attention", "flash_attention_fwd"),
            ("flash_decode", "flash_decode_f32"),
            ("flash_decode_proj", "flash_decode_proj_f32"),
            ("flash_attention_bwd", "flash_attention_bwd"),
            ("mamba_scan_bwd", "mamba_scan_bwd_f32")) if n in libs}
        argtypes = {
            "nest_gemm": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_void_p],
            "fused_chain": [ctypes.c_void_p] * 6 + [ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
            "flash_attention": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p],
            "flash_decode": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p],
            "flash_decode_proj": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p],
            "flash_attention_bwd": [ctypes.c_void_p] * 10
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
            "mamba_scan_bwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
            + [ctypes.c_void_p]}
        for name, fn in fns.items():
            fn.argtypes = argtypes[name]
            fn.restype = ctypes.c_int
        self.ng = fns.get("nest_gemm")
        self.fc = fns.get("fused_chain")
        self.fa = fns.get("flash_attention")
        self.fd = fns.get("flash_decode")
        self.fd_bf16 = None
        if "flash_decode" in libs:
            lib = ctypes.CDLL(libs["flash_decode"])
            if hasattr(lib, "flash_decode_bf16"):
                self.fd_bf16 = lib.flash_decode_bf16
                self.fd_bf16.argtypes = argtypes["flash_decode"]
                self.fd_bf16.restype = ctypes.c_int
        self.fdp = fns.get("flash_decode_proj")
        self.fab = fns.get("flash_attention_bwd")
        self.msb = fns.get("mamba_scan_bwd")
        if self.msb is not None:
            self.msb_lib = ctypes.CDLL(libs["mamba_scan_bwd"])
            self.msb_lib.mamba_scan_bwd_blocks.argtypes = [ctypes.c_int] * 2

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

    def flash_attention(self, q, k, v, *, causal):
        bh, s, d = q.shape
        out = torch.empty_like(q)
        err = self.fa(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), bh, s, k.shape[1], d, k.shape[1],
                      int(causal), int(q.dtype == torch.bfloat16),
                      d ** -0.5, build.stream_handle())
        build.raise_on_error(err, "earlier flash_attention")
        return out

    def flash_decode(self, q, k, v, lengths, scale=1.0):
        b, sq, d = q.shape
        dv = v.shape[2]
        fn = self.fd_bf16 if q.dtype == torch.bfloat16 else self.fd
        out = torch.empty((b, sq, dv), device=q.device, dtype=q.dtype)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), b, sq, k.shape[1], d,
                 dv, scale, build.stream_handle())
        build.raise_on_error(err, "earlier flash_decode")
        return out

    def flash_decode_proj(self, q, k, v, lengths, wo, *, m_out, k_out):
        """The earlier kernel held its requests' contexts in one block's
        shared memory, so its group is the old ``proj_group``'s."""
        b, sq, d = q.shape
        dv, n_out = v.shape[2], wo.shape[1]
        base = sq * d + 16 * (d + dv) + sq * 16 + 3 * sq
        group = min(b, (fa.PROJ_SMEM_LIMIT // 4 - base) // (sq * dv))
        out = torch.empty((b, m_out, n_out), device=q.device)
        err = self.fdp(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       lengths.data_ptr(), wo.data_ptr(), out.data_ptr(), b,
                       sq, k.shape[1], d, dv, m_out, k_out, n_out, group,
                       1.0, build.stream_handle())
        build.raise_on_error(err, "earlier flash_decode_proj")
        return out


    def flash_attention_bwd(self, q, k, v, o, lse, do, *, causal):
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        bh, s, d = q.shape
        dsum = torch.empty((bh, s), device=q.device)
        err = self.fab(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), bh, s,
                       k.shape[1], d, k.shape[1], int(causal),
                       int(q.dtype == torch.bfloat16), d ** -0.5,
                       build.stream_handle())
        build.raise_on_error(err, "earlier flash_attention_bwd")
        return dq, dk, dv

    def mamba_scan_bwd(self, da, dbx, c, h0, dy):
        b, seq, d, n = da.shape
        blocks = self.msb_lib.mamba_scan_bwd_blocks(d, n)
        dda, ddbx = torch.empty_like(da), torch.empty_like(dbx)
        dc = torch.empty((b, seq, n), device=da.device)
        dh0 = torch.empty((b, d, n), device=da.device)
        ckpt = torch.empty((b, -(-seq // 16), d, n), device=da.device)
        dc_part = torch.empty((b, blocks, seq, n), device=da.device)
        err = self.msb(da.data_ptr(), dbx.data_ptr(), c.data_ptr(),
                       h0.data_ptr(), dy.data_ptr(), None, dda.data_ptr(),
                       ddbx.data_ptr(), dc.data_ptr(), dh0.data_ptr(),
                       ckpt.data_ptr(), dc_part.data_ptr(), b, seq, d, n,
                       build.stream_handle())
        build.raise_on_error(err, "earlier mamba_scan_bwd")
        return dda, ddbx, dc, dh0


class ReadFlush(cs.Timer):
    """``chip_smoke.Timer`` with L2 cleared by reading 256 MB: clean lines,
    nothing to write back.  A probe, not the yardstick."""

    def clear_l2(self) -> None:
        self.flush.sum()


def compare(label, new, old, timer, tol=None) -> None:
    """Both outputs on the same inputs (``torch.equal``, or with ``tol`` =
    (rtol, atol) ``torch.allclose`` and the largest difference), then the
    times: this tree's kernel, the earlier one, this tree's again."""
    a_out, b_out = new(), old()
    if not isinstance(a_out, tuple):         # one output, or several
        a_out, b_out = (a_out,), (b_out,)
    pairs = list(zip(a_out, b_out, strict=True))
    same = f"torch.equal {[torch.equal(a, b) for a, b in pairs]}"
    if tol is not None:
        close = all(torch.allclose(a.float(), b.float(), rtol=tol[0],
                                   atol=tol[1]) for a, b in pairs)
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in pairs)
        same += (f", torch.allclose (rtol {tol[0]}, atol {tol[1]}) {close},"
                 f" max |diff| {diff:.3g}")
    del a_out, b_out, pairs
    a, b, c = timer(new), timer(old), timer(new)
    print(f"  {label} | {same} | this tree {cs.spread(a)} then "
          f"{cs.spread(c)} | earlier {cs.spread(b)}", flush=True)


def compare_gemms(old, gen, timer) -> None:
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


def compare_fused(old, gen, timer) -> None:
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


def compare_attention(old, gen, timer) -> None:
    b, s, h, d = cs.ATTN_SHAPE
    print(f"flash_attention: BH {b * h} S {s} d {d} causal, chip_smoke.py's "
          f"inputs", flush=True)
    q, k, v = cs.attention_inputs(gen)
    for dtype, tol in ((torch.float32, (cs.RTOL, cs.RTOL * d)),
                       (torch.bfloat16, (2e-2, 2e-1))):
        qt, kt, vt = (x.to(dtype) for x in (q, k, v))
        compare(f"{str(dtype).split('.')[1]}",
                lambda: fa.flash_attention(qt, kt, vt, causal=True),
                lambda: old.flash_attention(qt, kt, vt, causal=True), timer,
                tol)
        del qt, kt, vt
    del q, k, v
    torch.cuda.empty_cache()


def compare_decode(old, gen, timer) -> None:
    print("flash_decode: B sq skv d dv lengths", flush=True)
    for b, sq, skv, d, lengths in cs.DECODE_CASES:
        q = torch.randn(b, sq, d, device="cuda", generator=gen)
        k = torch.randn(b, skv, d, device="cuda", generator=gen) * 0.5
        v = torch.randn(b, skv, d, device="cuda", generator=gen)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        compare(f"{b} {sq} {skv} {d} {d} {list(lengths)}",
                lambda: fa.flash_decode(q, k, v, lens),
                lambda: old.flash_decode(q, k, v, lens), timer,
                (cs.RTOL, cs.RTOL * d))
    floor = timer(cs.launch_floor)
    print(f"  empty kernel (launch floor): {cs.spread(floor)}", flush=True)
    new, earlier = (cs.decode_digests(fn) for fn in (fa.flash_decode,
                                                     old.flash_decode))
    for case, a, b in zip(cs.DIGEST_CASES, new, earlier):
        print(f"  fp32 digest {case[:5]}: this tree {a} earlier {b} "
              f"(equal {a == b})", flush=True)
    if old.fd_bf16 is None:
        return
    print("flash_decode bf16: chip_smoke.py's rows, B sq skv d dv "
          "length", flush=True)
    for name in ("flash_decode_cross", "flash_decode_mla",
                 "flash_decode_bf16"):
        q, k, v, lens, scale = cs.decode_bf16_inputs(name, gen)
        case = cs.decode_bf16_case(name)
        compare(f"{name} {case[:6]}",
                lambda: fa.flash_decode(q, k, v, lens, scale=scale),
                lambda: old.flash_decode(q, k, v, lens, scale),
                timer, (cs.DECODE_BF16_RTOL[name], cs.RTOL * case[3]))


def compare_decode_proj(old, gen, timer) -> None:
    dec = ModelExecutable.for_cell("gemma-7b", "decode_tiny",
                                   feather_config(16, 256),
                                   cache=ProgramCache(), reduce_model=False)
    a = cs.attention_proj_inputs(dec, gen)
    q, k, v, wo, lens = a["q"], a["k"], a["v"], a["wo"], a["lens"]
    kw = dict(m_out=a["m_out"], k_out=a["k_out"])
    print(f"flash_decode_proj: chip_smoke.py's K4 case, B {q.shape[0]} "
          f"lengths {lens.tolist()} adapt ({a['m_out']}, {a['k_out']}) @ wo "
          f"{tuple(wo.shape)}", flush=True)
    for label, t in (("K4", timer), ("K4, L2 cleared by reading (probe)",
                                     ReadFlush())):
        compare(label, lambda: fa.flash_decode_proj(q, k, v, lens, wo, **kw),
                lambda: old.flash_decode_proj(q, k, v, lens, wo, **kw), t,
                (cs.RTOL, cs.RTOL * a["k_out"]))


def compare_attention_bwd(old, gen, timer) -> None:
    bh, s, d = cs.TRAIN_ATTN_CASE
    print(f"flash_attention_bwd: BH {bh} S {s} d {d} causal, chip_smoke.py's "
          f"inputs: (dq, dk, dv)", flush=True)
    for dtype, tol in ((torch.float32, (cs.RTOL, cs.RTOL)),
                       (torch.bfloat16, (2e-2, 2e-2))):
        q = (torch.randn(bh, s, d, device="cuda", generator=gen) * 8.0
             ).to(dtype)
        k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen
                                ).to(dtype) for _ in range(3))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        compare(f"{str(dtype).split('.')[1]}",
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=True),
                lambda: old.flash_attention_bwd(q, k, v, o, lse, do,
                                                causal=True), timer, tol)
        del q, k, v, do, o, lse
    torch.cuda.empty_cache()


def compare_scan_bwd(old, gen, timer) -> None:
    b, seq, d, n = cs.TRAIN_SCAN_SHAPE
    print(f"mamba_scan_bwd: {cs.TRAIN_SCAN_SHAPE}, da a head's scalar: (dda, "
          f"ddbx, dc, dh0), this tree given the forward's states", flush=True)
    da = (0.7 + 0.299 * torch.rand(b, seq, device="cuda", generator=gen)
          )[..., None, None].expand(b, seq, d, n).contiguous()
    dbx = torch.randn(b, seq, d, n, device="cuda", generator=gen) * 0.1
    c = torch.randn(b, seq, n, device="cuda", generator=gen)
    h0 = torch.randn(b, d, n, device="cuda", generator=gen) * 0.1
    dy = torch.randn(b, seq, d, device="cuda", generator=gen)
    states = ms.mamba_scan(da, dbx, c, h0, return_states=True)[2]
    compare("fp32", lambda: ms.mamba_scan_bwd(da, dbx, c, h0, dy,
                                              states=states),
            lambda: old.mamba_scan_bwd(da, dbx, c, h0, dy), timer,
            (cs.RTOL, cs.RTOL * d))
    del da, dbx, c, h0, dy, states
    torch.cuda.empty_cache()


def main(argv) -> int:
    if len(argv) != 1:
        print("usage: compare_kernels.py OLD_CSRC_DIR", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card()}", flush=True)
    old = Old(argv[0])
    build.build(tuple(old.names) + ("empty",))
    print(f"earlier kernels from {argv[0]}: {old.names}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer()
    for name, fn in (("nest_gemm", compare_gemms),
                     ("fused_chain", compare_fused),
                     ("flash_attention", compare_attention),
                     ("flash_decode", compare_decode),
                     ("flash_decode_proj", compare_decode_proj),
                     ("flash_attention_bwd", compare_attention_bwd),
                     ("mamba_scan_bwd", compare_scan_bwd)):
        if name in old.names:
            fn(old, gen, timer)
    print(cs.card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
