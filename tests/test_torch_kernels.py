"""The port's kernels on the CPU: each plain PyTorch version against the
JAX package's Pallas kernel in interpret mode, on the same seeded numpy
inputs (rtol 2e-4, atol 2e-4 * k, the reference's ``cross_check``
tolerance).  The CUDA kernels themselves are held against these plain
versions on a card by ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from test_torch_cuda import (DECODE_CASES, FUSED_CASES, NEST_CASES,
                             _decode_inputs, _fused_inputs, _np, _t)

from repro.kernels import fused_chain as jfc
from repro.kernels import nest_gemm as jng
from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_chain as fc
from repro_torch.kernels import nest_gemm as ng

# ---------------------------------------------------------------------------
# plain versions == Pallas (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bk", [16, 128])
@pytest.mark.parametrize("m,k,n,out_t,act", NEST_CASES)
def test_nest_gemm_plain_matches_pallas(m, k, n, out_t, act, bk):
    x, w = _np((m, k)), _np((k, n), k ** -0.5)
    want = np.asarray(jops.nest_gemm(x, w, bk=bk, interpret=True,
                                     out_block_t=out_t, act=act))
    got = ops.nest_gemm(_t(x), _t(w), bk=bk, out_block_t=out_t,
                        act=act).numpy()
    assert got.shape == want.shape == ((n, m) if out_t else (m, n))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * k)


@pytest.mark.parametrize("dims,bm,bks,acts,adapts", FUSED_CASES)
def test_fused_chain_plain_matches_pallas(dims, bm, bks, acts, adapts):
    x, ws = _fused_inputs(dims)
    want = np.asarray(jops.fused_chain(x, ws, bm=bm, bks=bks, acts=acts,
                                       adapts=adapts, dims=dims,
                                       interpret=True))
    got = ops.fused_chain(_t(x), [_t(w) for w in ws], bm=bm, bks=bks,
                          acts=acts, adapts=adapts, dims=dims).numpy()
    k_max = max(d[1] for d in dims)
    assert got.shape == want.shape == (dims[-1][0], dims[-1][2])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * k_max)


@pytest.mark.parametrize("qshape,skv,lengths,bkv", DECODE_CASES)
def test_flash_decode_plain_matches_pallas(qshape, skv, lengths, bkv):
    q, k, v = _decode_inputs(qshape, skv)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jops.flash_decode(q, k, v, lens, bkv=bkv,
                                        interpret=True))
    got = ops.flash_decode(_t(q), _t(k), _t(v), lens, bkv=bkv).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * qshape[2])
    if 0 in lengths:            # a fully masked request contributes p = 0
        assert not got[list(lengths).index(0)].any()


def test_activation_registries_agree_with_jax():
    x = _np((5, 33), 3.0)
    for name, fn in jfc.FUSED_ACT_FNS.items():
        want = np.asarray(fn(x))
        got = ref.FUSED_ACT_FNS[name](_t(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert set(ref.ACT_FNS) == set(jng.ACT_FNS)
    assert set(ng.ACT_CODES) - {None} == set(ref.ACT_FNS)
    assert set(fc.ACT_CODES) - {None} == set(ref.FUSED_ACT_FNS)


def test_fused_geometry_matches_pallas_launch():
    """The kernel's (bm, blocks, K tiles, slab) geometry is the TPU
    kernel's: adapts force one block of every row."""
    dims = ((16, 32, 48), (16, 48, 64), (16, 64, 24))
    assert fc.geometry(dims, 8, (16, 16, 32), (False,) * 3) \
        == (8, 2, (16, 16, 32), 64, 64)
    dims = ((4, 24, 32), (8, 16, 20), (8, 20, 12))
    assert fc.geometry(dims, 4, (8, 32, 8), (False, True, False)) \
        == (8, 1, (8, 16, 8), 24, 32)
    assert fc.placement(8, 24, 32) == "shared"
    assert fc.placement(64, 512, 512) == "global"


def test_kernel_launchers_refuse_cpu_tensors():
    """A launcher never falls back: CPU tensors are refused before any
    build, and the plain version runs only through ``ops``."""
    before = (ng.launches, fc.launches, fa.launches)
    x, w = torch.ones(2, 3), torch.ones(3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ng.nest_gemm(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        fc.fused_chain(x, [w], bm=2, bks=(3,), acts=(None,))
    q = torch.ones(1, 1, 3)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_decode(q, q, q, torch.ones(1, dtype=torch.int32))
    assert (ng.launches, fc.launches, fa.launches) == before


def test_build_targets_are_content_addressed():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
        t = build.target(name)
        assert t.parent == build.BUILD_DIR and t.name.startswith(f"lib{name}-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
