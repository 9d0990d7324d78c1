"""The hand-written CUDA kernels against their plain PyTorch versions, on
the same device tensors (rtol 2e-4, atol 2e-4 * k).  Every test here is
marked ``cuda`` and skips without a card; the file imports no JAX, so on
a machine with a card it runs alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The case tables are shared with ``test_torch_kernels.py``, which holds
the plain versions against the JAX package on the CPU."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_chain as fc
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import nest_gemm as ng

RNG = np.random.default_rng(11)


def _np(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions' matmuls in full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (m, k, n, out_block_t, act): decode rows, IO-S stores, every fused act,
# fully ragged extents
NEST_CASES = [
    (1, 64, 64, False, None),
    (4, 64, 256, True, None),
    (33, 17, 65, False, "relu"),
    (8, 256, 64, True, "gelu"),
    (5, 40, 88, True, "silu"),
    (32, 300, 24, False, "gelu"),
]

# past 8 rows: two row blocks of 8 (M = 16), row blocks of 32 on 16-column
# float4 strips, on scalar columns (ragged N) and on the wide-weight path;
# the K of every main-path shape
TALL_NEST_CASES = [
    (16, 3072, 4096, True, None),
    (31, 300, 8200, False, "gelu"),
    (32, 24576, 3072, True, None),
    (32, 1000, 24576, False, "silu"),
]

# (dims, bm, bks, acts, adapts): a two-block wired chain, head-split
# adapts (shrink and cycle-growth) with the row-wise acts
FUSED_CASES = [
    (((16, 32, 48), (16, 48, 64), (16, 64, 24)), 8, (16, 16, 32),
     ("relu", None, "softmax"), (False, False, False)),
    (((4, 24, 32), (8, 16, 20), (8, 20, 12)), 4, (8, 16, 8),
     (None, "rmsnorm", "layernorm"), (False, True, False)),
    (((2, 8, 6), (3, 10, 7)), 2, (4, 4),
     ("gelu", "softmax"), (False, True)),
    (((6, 20, 36), (6, 36, 30)), 4, (7, 9),
     ("silu", "layernorm"), (False, False)),
]

# the reduced cell's decode@8 and prefill MLP segments, a layer width that
# no cluster size divides (the last rank owns no column), an adapt and a
# row-wise act on rows gathered across 8 ranks, a 64-row slab in shared
# memory with the weights read from device memory, and the bucket-8
# prefill plan's greedy geometry, whose slab fits no block
CLUSTER_CASES = [
    (((8, 64, 256), (8, 256, 64), (8, 64, 256)), 8, (10, 42, 10),
     (None, "gelu", None), (False,) * 3),
    (((32, 64, 256), (32, 256, 64), (32, 64, 256)), 32, (10, 42, 10),
     (None, "gelu", None), (False,) * 3),
    (((8, 40, 100), (8, 100, 52)), 8, (16, 24), ("relu", "rmsnorm"),
     (False, False)),
    (((8, 64, 96), (12, 64, 80), (12, 80, 40)), 8, (16, 32, 16),
     ("gelu", "softmax", "layernorm"), (False, True, False)),
    (((64, 256, 512), (64, 512, 512), (64, 512, 128)), 64, (128,) * 3,
     ("relu", "gelu", "silu"), (False,) * 3),
    (((256, 64, 256), (256, 256, 64), (256, 64, 256)), 256, (10, 42, 10),
     (None, "gelu", None), (False,) * 3),
]

# (q shape, skv, lengths, bkv)
DECODE_CASES = [
    ((4, 1, 8), 16, (16, 5, 1, 9), 128),
    ((3, 2, 8), 12, (12, 3, 7), 8),
    ((2, 1, 16), 40, (0, 33), 16),
]


# (B, sq, skv, d, lengths, m_out, k_out, n_out): the adapt geometries of
# tests/test_batched_decode.py (shrink, identity, growth), a length-0
# request, and non-float4 column counts
PROJ_CASES = [
    (3, 1, 16, 12, (16, 7, 11), 1, 12, 6),
    (3, 1, 16, 12, (16, 7, 11), 2, 8, 6),
    (3, 1, 16, 12, (16, 7, 11), 3, 5, 6),
    (2, 2, 40, 16, (0, 33), 3, 20, 72),
    (5, 3, 9, 8, (9, 1, 4, 9, 2), 2, 30, 13),
]

# (b, s, h, d, causal): tests/test_kernels.py's flash_attention grid
ATTN_CASES = [
    (2, 128, 2, 64, True), (2, 128, 2, 64, False),
    (1, 256, 4, 32, True), (2, 192, 1, 128, True),
    (1, 320, 2, 64, False),
]

# (b, l, d, n): tests/test_kernels.py's mamba_scan grid, and Mamba-2's
# state width 64 (zamba2-1.2b), two state elements a lane
SCAN_CASES = [(2, 64, 32, 16), (1, 128, 64, 8), (2, 256, 16, 4),
              (2, 64, 32, 64)]


def _proj_inputs(b, sq, skv, d, k_out, n_out):
    return (_np((b, sq, d)), _np((b, skv, d)), _np((b, skv, d)),
            _np((k_out, n_out)))


def _attn_inputs(b, s, h, d, sk=None):
    sk = s if sk is None else sk
    return (_np((b, s, h, d), 0.3), _np((b, sk, h, d), 0.3),
            _np((b, sk, h, d)))


def _scan_inputs(b, l, d, n):
    da = RNG.uniform(0.7, 0.999, (b, l, d, n)).astype(np.float32)
    return da, _np((b, l, d, n), 0.1), _np((b, l, n)), _np((b, d, n), 0.1)


def _fused_inputs(dims):
    x = _np(dims[0][:2])
    ws = [_np(d[1:], d[1] ** -0.5) for d in dims]
    return x, ws


def _decode_inputs(qshape, skv):
    b, _, d = qshape
    return (_np(qshape), _np((b, skv, d), 0.5), _np((b, skv, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,out_t,act", NEST_CASES + [
    (3, 96, 8200, True, "silu"),          # 32-column strips, ragged edge
    (8, 300, 16384, False, "relu"),
    (4, 24576, 3072, True, None),         # the widest K of the main path
] + TALL_NEST_CASES)
def test_nest_gemm_kernel_matches_plain(cuda, m, k, n, out_t, act):
    # unit-normal W: outputs of RMS sqrt(k), far above the 2e-4*k atol
    x, w = _t(_np((m, k)), cuda), _t(_np((k, n)), cuda)
    before = ng.launches
    got = ops.nest_gemm(x, w, out_block_t=out_t, act=act)
    want = ref.nest_gemm_ref(x, w, out_block_t=out_t, act=act)
    torch.cuda.synchronize()
    # the wide-weight path is two launches: X group-major, then the GEMM
    wide = ng.scratch_floats(m, k, n, w.data_ptr()) > 0
    assert ng.launches == before + (2 if wide else 1)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * k)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 24576, 8200])
def test_nest_gemm_kernel_rows_independent_of_batch(cuda, n):
    """The spine invariant: a row's K sum does not depend on M or on the
    row block (1 to 32 rows), so the rows of a stacked launch are
    bit-equal to the rows launched alone."""
    k = 3072
    x, w = _t(_np((32, k)), cuda), _t(_np((k, n), k ** -0.5), cuda)
    for out_t in (False, True):
        full = ng.nest_gemm(x, w, out_block_t=out_t, act="gelu")
        for m in (1, 2, 4, 8, 16, 24, 32):
            part = ng.nest_gemm(x[:m].contiguous(), w, out_block_t=out_t,
                                act="gelu")
            want = full[:, :m] if out_t else full[:m]
            assert torch.equal(part, want), (out_t, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,bm,bks,acts,adapts",
                         FUSED_CASES + CLUSTER_CASES)
def test_fused_chain_kernel_matches_plain(cuda, dims, bm, bks, acts, adapts):
    x, ws = _fused_inputs(dims)
    x, ws = _t(x, cuda), [_t(w, cuda) for w in ws]
    before = fc.launches
    got = ops.fused_chain(x, ws, bm=bm, bks=bks, acts=acts, adapts=adapts,
                          dims=dims)
    want = ref.fused_chain_ref(x, ws, bks=bks, acts=acts, adapts=adapts,
                               dims=dims)
    torch.cuda.synchronize()
    assert fc.launches == before + 1
    k_max = max(d[1] for d in dims)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * k_max)


@pytest.mark.cuda
@pytest.mark.parametrize("qshape,skv,lengths,bkv", DECODE_CASES + [
    ((4, 1, 256), 16, (16, 1, 9, 5), 128),            # the main path's
])
def test_flash_decode_kernel_matches_plain(cuda, qshape, skv, lengths, bkv):
    q, k, v = (_t(a, cuda) for a in _decode_inputs(qshape, skv))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = fa.launches
    got = ops.flash_decode(q, k, v, lens)
    want = ref.flash_decode_ref(q, k, v, lens, bkv=bkv)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    torch.testing.assert_close(got, want, rtol=2e-4,
                               atol=2e-4 * qshape[2])


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,d,lengths,m_out,k_out,n_out",
                         PROJ_CASES + [
    (4, 1, 16, 256, (16, 1, 9, 5), 1, 4096, 3072),   # the main path's
    (4, 16, 16, 256, (16, 1, 9, 5), 1, 4096, 3072),  # 16 query rows
    (3, 8, 20, 1024, (20, 3, 11), 2, 700, 64),       # d 1024, 4-key tiles
    (1, 1, 16, 256, (9,), 1, 4096, 3072),            # one request
    # k_out off the K slice (ranks of 544 rows, the last one short),
    # n_out off the float4 grid (scalar copies), a length-0 request
    (5, 1, 16, 256, (16, 0, 9, 5, 1), 1, 4100, 3070),
    # past one context a rank: 9 and 17 requests, rows in several passes
    (9, 1, 16, 64, (16, 1, 9, 5, 0, 3, 16, 2, 7), 2, 4000, 200),
    (17, 2, 40, 32, tuple(range(0, 40, 3)) + (40,) * 3, 3, 130, 96),
    (20, 8, 20, 1024, (20, 3, 11) * 6 + (0, 20), 2, 700, 64),  # 5 groups
    (20, 4, 20, 1024, (20, 3, 11) * 6 + (0, 20), 2, 700, 64),  # 2 groups
    (2, 1, 8, 16, (8, 3), 1, 5, 6),                  # ranks with no K rows
    (3, 2, 16, 10, (16, 7, 0), 2, 10, 36),           # q/K/V by 4-byte copies
])
def test_flash_decode_proj_kernel_matches_plain(cuda, b, sq, skv, d, lengths,
                                                m_out, k_out, n_out):
    q, k, v, wo = (_t(a, cuda) for a in _proj_inputs(b, sq, skv, d, k_out,
                                                      n_out))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = fa.proj_launches
    got = ops.flash_decode_proj(q, k, v, wo, lens, m_out=m_out, k_out=k_out)
    want = ref.flash_decode_proj_ref(q, k, v, lens, wo, m_out=m_out,
                                     k_out=k_out)
    torch.cuda.synchronize()
    assert fa.proj_launches == before + 1
    assert got.shape == (b, m_out, n_out)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * k_out)
    if 0 in lengths:            # a fully masked request projects zeros
        assert not got[list(lengths).index(0)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_out", [3072, 3070])
def test_flash_decode_proj_kernel_rows_independent_of_batch(cuda, n_out):
    """Each request's rows of a 4-request launch are bit-equal to the same
    request launched alone: the K split depends on k_out alone."""
    q, k, v, wo = (_t(a, cuda) for a in _proj_inputs(4, 1, 16, 256, 4096,
                                                      n_out))
    lens = torch.tensor((16, 1, 9, 5), dtype=torch.int32, device=cuda)
    both = fa.flash_decode_proj(q, k, v, lens, wo, m_out=1, k_out=4096)
    for r in range(4):
        alone = fa.flash_decode_proj(q[r:r + 1], k[r:r + 1], v[r:r + 1],
                                     lens[r:r + 1], wo, m_out=1, k_out=4096)
        assert torch.equal(alone[0], both[r]), r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-4, 2e-4),
                                             (torch.bfloat16, 2e-2, 2e-1)])
@pytest.mark.parametrize("b,s,h,d,causal", ATTN_CASES + [
    (1, 200, 2, 256, True),                  # gemma-7b's head_dim
    (1, 70, 1, 20, False),                   # head_dim off the 32 grid
])
def test_flash_attention_kernel_matches_plain(cuda, b, s, h, d, causal,
                                              dtype, rtol, atol):
    q, k, v = (_t(a, cuda).to(dtype) for a in _attn_inputs(b, s, h, d))
    before = fa.attention_launches
    got = ops.flash_attention(q, k, v, causal=causal)
    fold = [x.transpose(1, 2).reshape(b * h, s, d) for x in (q, k, v)]
    want = ref.flash_attention_ref(*fold, causal=causal)
    want = want.reshape(b, h, s, d).transpose(1, 2)
    torch.cuda.synchronize()
    assert fa.attention_launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_flash_attention_kernel_masks_blockaligned_padded_kv(cuda):
    """A block-aligned kv_len shorter than the buffer still masks every
    padded key: poisoned padding must not leak into the output."""
    bh, s, d, real_kv = 2, 64, 32, 64
    q = _t(_np((bh, s, d), 0.3), cuda)
    k, v = _t(_np((bh, real_kv, d), 0.3), cuda), _t(_np((bh, real_kv, d)),
                                                     cuda)
    poison = torch.full((bh, 64, d), 100.0, device=cuda)
    got = fa.flash_attention(q, torch.cat([k, poison], 1),
                             torch.cat([v, poison], 1), causal=False,
                             kv_len=real_kv)
    want = ref.flash_attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_fp32_accuracy(cuda, causal):
    """fp32 on the tensor cores keeps fp32 accuracy (three TF32 products a
    pair of fragments): q at 8x scale gives scores of std ~8, where one
    TF32 pass would move the output by ~1e-3; the bound is 1e-4 absolute
    on outputs of RMS ~0.8."""
    bh, s, d = 2, 512, 256
    q = _t(_np((bh, s, d), 8.0), cuda)
    k, v = _t(_np((bh, s, d)), cuda), _t(_np((bh, s, d)), cuda)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-4, 2e-4),
                                             (torch.bfloat16, 2e-2, 2e-1)])
@pytest.mark.parametrize("s,sk,d,causal,kv_len", [
    (200, 333, 64, False, None),     # neither a multiple of the tiles
    (129, 129, 128, True, None),     # one row past a query block
    (77, 45, 80, True, 31),          # head_dim off the 32 grid, short kv
    (150, 96, 256, False, 70),       # kv_len inside a KV tile
    (64, 130, 256, True, 128),       # block-aligned kv_len, ragged buffer
    (33, 17, 20, False, 0),          # every key masked: zeros
])
def test_flash_attention_kernel_ragged(cuda, s, sk, d, causal, kv_len,
                                       dtype, rtol, atol):
    """Direct launches on extents that are no multiple of the kernel's
    128-row query blocks or 32-key tiles, with keys at or past kv_len
    masked (poisoned, so a leak would show)."""
    bh = 3
    q = _t(_np((bh, s, d), 0.3), cuda).to(dtype)
    k, v = _t(_np((bh, sk, d), 0.3), cuda), _t(_np((bh, sk, d)), cuda)
    real = sk if kv_len is None else kv_len
    k[:, real:] = 100.0
    v[:, real:] = 100.0
    k, v = k.to(dtype), v.to(dtype)
    got = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    want = ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (bh, s, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if real == 0:
        assert not got.float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-4, 2e-4),
                                             (torch.bfloat16, 2e-2, 2e-1)])
@pytest.mark.parametrize("d", [64, 80, 128, 256])
def test_flash_attention_kernel_head_dims(cuda, d, dtype, rtol, atol):
    q, k, v = (_t(a, cuda).to(dtype) for a in _attn_inputs(1, 256, 2, d))
    got = ops.flash_attention(q, k, v, causal=True)
    fold = [x.transpose(1, 2).reshape(2, 256, d) for x in (q, k, v)]
    want = ref.flash_attention_ref(*fold, causal=True)
    want = want.reshape(1, 2, 256, d).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("qshape,skv,lengths,dv", [
    ((3, 20, 64), 37, (0, 37, 16), 96),    # two row groups, a part strip
    ((2, 5, 256), 50, (50, 17), 512),      # four tiles, the last ragged
    ((5, 1, 16), 16, (16,) * 5, 16),       # the reduced serve's widths
    ((4, 1, 256), 16, (16,) * 4, 256),     # the full-width serve's
    ((2, 3, 20), 19, (19, 4), 28),         # d and dv off the float4 grid
])
def test_flash_decode_kernel_shapes(cuda, qshape, skv, lengths, dv):
    """Query rows past one block's 16, KV past one 16-position tile,
    lengths from 0 to skv, output strips of 64 columns and part of one,
    and the serves' shapes."""
    b, sq, d = qshape
    q = _t(_np(qshape), cuda)
    k, v = _t(_np((b, skv, d), 0.5), cuda), _t(_np((b, skv, dv)), cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = fa.launches
    got = fa.flash_decode(q, k, v, lens)
    want = ref.flash_decode_ref(q, k, v, lens)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and got.shape == (b, sq, dv)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4 * d)
    if 0 in lengths:            # a request of length 0 gives zeros
        assert not got[list(lengths).index(0)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-4, 2e-4),
                                             (torch.bfloat16, 2e-2, 2e-1)])
def test_flash_attention_kernel_mla_value_width(cuda, dtype, rtol, atol):
    """MLA's prefill: q/k heads 192 wide, values 128 wide (zero-padded to
    192 by the wrapper, the kernel's 192 instance), against the plain
    version on the unpadded values."""
    b, s, h, d, dv = 2, 70, 4, 192, 128
    q, k = (_t(_np((b, s, h, d)), cuda).to(dtype) for _ in range(2))
    v = _t(_np((b, s, h, dv)), cuda).to(dtype)
    before = fa.attention_launches
    got = ops.flash_attention(q, k, v, causal=True)
    fold = [x.transpose(1, 2).reshape(b * h, s, x.shape[-1])
            for x in (q, k, v)]
    want = ref.flash_attention_ref(*fold, causal=True)
    want = want.reshape(b, h, s, dv).transpose(1, 2)
    torch.cuda.synchronize()
    assert fa.attention_launches == before + 1
    assert got.dtype == dtype and got.shape == (b, s, h, dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-4, 0.1152),
                                             (torch.bfloat16, 1e-2, 1e-2)])
def test_flash_decode_kernel_mla_shape(cuda, dtype, rtol, atol):
    """MLA's absorbed decode: 128 query rows (8 row groups) of d = 576
    against values of dv = 512 (shared memory past 48 KB in both types),
    scale 192**-0.5, ragged lengths; fp32 at the fp32 cases' atol of
    2e-4 * d, bf16 within a bf16 place."""
    b, sq, skv, d, dv = 3, 128, 49, 576, 512
    q = _t(_np((b, sq, d)), cuda).to(dtype)
    k = _t(_np((b, skv, d), 0.5), cuda).to(dtype)
    v = _t(_np((b, skv, dv)), cuda).to(dtype)
    lens = torch.tensor((47, 1, 33), dtype=torch.int32, device=cuda)
    before = fa.launches
    got = ops.flash_decode(q, k, v, lens, scale=192 ** -0.5)
    want = ref.flash_decode_ref(q, k, v, lens, scale=192 ** -0.5)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, sq, dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b"])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced MoE layer (fp32, the published capacity factor 1.25, so
    tokens are dropped) on the card against the same layer on the CPU:
    the routes (every array of ``moe.route``) equal, the output and aux
    within 2e-4 + 2e-4 * |cpu|."""
    from repro_torch.models import build_model, moe
    cfg = _zoo_config(arch)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    layers = [m.net.layers[0].moe for m in (cpu, card)]
    for layer in layers:
        layer.capacity_factor = 1.25
    x = _t(_np((2, 128, cfg.d_model)))
    routes = []
    orig = moe.route

    def record(*args):
        out = orig(*args)
        routes.append([t.cpu() for t in out])
        return out
    moe.route = record
    try:
        want, want_aux = layers[0](x)
        got, got_aux = layers[1](x.to(cuda))
        torch.cuda.synchronize()
    finally:
        moe.route = orig
    assert not routes[0][3].all()                # tokens dropped
    for a, c in zip(*routes):
        assert torch.equal(a, c)
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,n", SCAN_CASES + [
    (1, 37, 33, 16),                         # ragged L and channel block
    (2, 40, 24, 3),                          # N padded to 4
    (1, 37, 33, 64),                         # ragged, two elements a lane
    (2, 40, 24, 48),                         # N padded to 64
])
def test_mamba_scan_kernel_matches_plain(cuda, b, l, d, n):
    da, dbx, c, h0 = (_t(a, cuda) for a in _scan_inputs(b, l, d, n))
    before = ms.launches
    y, h = ops.mamba_scan(da, dbx, c, h0)
    y_ref, h_ref = ref.mamba_scan_ref(da, dbx, c, h0)
    torch.cuda.synchronize()
    assert ms.launches == before + 1
    # the state is a rounded multiply then a rounded add in both
    # versions: bit-equal; y differs only in its sum order over n
    assert torch.equal(h, h_ref)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4 * n)


@pytest.mark.cuda
def test_mamba_scan_kernel_mamba2_folded(cuda):
    """Mamba-2's call (``models.ssm.Mamba2``): heads folded into the
    batch, [B * H, L, P, N] at N = 64, da a head's scalar a step expanded
    over (P, N), a stride-0 view the wrapper makes contiguous.  The state
    bit-equal, y within the sum order's tolerance."""
    b, h, seq, p, n = 2, 4, 33, 64, 64
    dt = _t(RNG.uniform(0.01, 0.2, (b, h, seq)).astype(np.float32), cuda)
    a = -_t(RNG.uniform(0.5, 2.0, (h,)).astype(np.float32), cuda)
    da = torch.exp(dt * a[:, None])[..., None, None].expand(
        b, h, seq, p, n).reshape(b * h, seq, p, n)
    assert da.stride()[-2:] == (0, 0)
    dbx = _t(_np((b * h, seq, p, n), 0.1), cuda)
    c = _t(_np((b * h, seq, n)), cuda)
    h0 = _t(_np((b * h, p, n), 0.1), cuda)
    before = ms.launches
    y, h_last = ops.mamba_scan(da, dbx, c, h0)
    y_ref, h_ref = ref.mamba_scan_ref(da, dbx, c, h0)
    torch.cuda.synchronize()
    assert ms.launches == before + 1
    assert torch.equal(h_last, h_ref)
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4 * n)


@pytest.mark.cuda
@pytest.mark.parametrize("mkn,ah,aw", [((17, 40, 88), 4, 16),
                                       ((12, 16, 12), 4, 4),
                                       ((64, 96, 72), 4, 16)])
def test_interpreter_on_the_card_matches_the_cpu(cuda, mkn, ah, aw):
    """The functional machine on the card: the same Program and inputs as
    on the CPU within 2e-4*k, and identical across two runs (its
    scatter-add, ``index_put_(accumulate=True)``, sums in one order)."""
    from repro_torch.backends import InterpreterBackend
    from repro_torch.configs.feather import feather_config
    from repro_torch.core import mapper
    m, k, n = mkn
    cfg = feather_config(ah, aw)
    prog = mapper.search(mapper.Gemm(m=m, k=k, n=n), cfg).program
    t = {"I": _np((m, k)), "W": _np((k, n))}
    runs = [InterpreterBackend(cfg).run_program(prog, t)[prog.out_name]
            for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0].is_cuda and torch.equal(runs[0], runs[1])
    cpu = InterpreterBackend(cfg, device="cpu").run_program(
        prog, t)[prog.out_name]
    torch.testing.assert_close(runs[0].cpu(), cpu, rtol=2e-4,
                               atol=2e-4 * k)
    torch.testing.assert_close(cpu, _t(t["I"]) @ _t(t["W"]), rtol=2e-4,
                               atol=2e-4 + 2e-4 * k)


# ---------------------------------------------------------------------------
# The multi-array path on the card: every shard a nest_gemm launch on its
# array's sub-backend, N-split weight slices made contiguous once
# ---------------------------------------------------------------------------

def _mesh_program(df, mkn):
    from repro_torch.configs.feather import feather_config
    from repro_torch.core import isa, mapper, program
    m, k, n = mkn
    choice = mapper.MappingChoice(df=getattr(isa.Dataflow, df), vn=4, m_t=8,
                                  k_t=8, n_t=8, n_kg=1, n_nb=1, dup=4)
    return program.lower(mapper.Gemm(m=m, k=k, n=n), choice,
                         feather_config(4, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("df", ["WOS", "IOS"])
def test_run_sharded_on_the_card_every_axis(cuda, df):
    """A 4-array ShardedProgram on the card, for every axis, against the
    same shards through the plain versions on the CPU: one nest_gemm
    launch a shard, and the N split's W slices (views that are not
    contiguous) reach the kernel."""
    from repro_torch.backends import CudaBackend
    from repro_torch.core import program
    from repro_torch.dist import ArrayMesh
    m, k, n = 24, 40, 72
    prog = _mesh_program(df, (m, k, n))
    x, w = _np((m, k)), _np((k, n))
    for axis in ("m", "n", "k"):
        sh = program.shard_program(prog, ArrayMesh(4), axis=axis)
        s1 = sh.shards[1]
        view = _t(w, cuda)[s1.k0:s1.k1, s1.n0:s1.n1]
        assert view.is_contiguous() == (axis != "n")
        be = CudaBackend(prog.cfg)
        before = ng.launches
        got = be.run_sharded(sh, {"I": _t(x, cuda),
                                  "W": _t(w, cuda)})[prog.out_name]
        torch.cuda.synchronize()
        assert got.is_cuda and got.shape == (m, n)
        assert ng.launches == before + sh.n_shards
        assert be.n_slice_copies == (sh.n_shards if axis == "n" else 0)
        want = CudaBackend(prog.cfg, device="cpu").run_sharded(
            sh, {"I": _t(x), "W": _t(w)})[prog.out_name]
        torch.testing.assert_close(got.cpu(), want, rtol=2e-4,
                                   atol=2e-4 * k)
        torch.testing.assert_close(got.cpu(), _t(x) @ _t(w), rtol=2e-4,
                                   atol=2e-4 + 2e-4 * k)


@pytest.mark.cuda
def test_weight_slices_copied_once_on_the_card(cuda):
    """A resident weight's N-split slices are copied on the first call
    only; a fresh source (a per-call KV operand) is copied again, and its
    entry goes once it has died."""
    from repro_torch.backends import CudaBackend
    from repro_torch.core import program
    from repro_torch.dist import ArrayMesh
    prog = _mesh_program("WOS", (1, 64, 96))
    sh = program.shard_program(prog, ArrayMesh(4), axis="n")
    be = CudaBackend(prog.cfg)
    t = {"I": _t(_np((1, 64)), cuda), "W": _t(_np((64, 96)), cuda)}
    outs = [be.run_sharded(sh, t)[prog.out_name].clone() for _ in range(3)]
    torch.cuda.synchronize()
    assert be.n_slice_copies == 4 and len(be.held_slices()) == 4
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    kv = {"I": t["I"], "W": t["W"].clone()}
    be.run_sharded(sh, kv)
    assert be.n_slice_copies == 8 and len(be._slices) == 2
    del kv
    be.run_sharded(sh, {"I": t["I"], "W": t["W"].clone()})
    assert be.n_slice_copies == 12 and len(be._slices) == 2
    be.run_sharded(sh, t)
    assert be.n_slice_copies == 12


@pytest.mark.cuda
@pytest.mark.parametrize("n_arrays", [1, 2])
def test_chaos_serve_on_the_card(cuda, n_arrays, tmp_path):
    """The standard fault plan on the cuda backend, flat (with a disk
    cache to corrupt) and on 2 arrays (one array_down, served on 1):
    every fault recovered, checksums equal to the fault-free serve's."""
    from repro_torch.configs.feather import feather_config
    from repro_torch.dist import ArrayMesh
    from repro_torch.faults import FaultInjector, FaultPlan
    from repro_torch.runtime import ModelExecutable, ProgramCache, Scheduler
    cfg = feather_config(4, 16)
    mesh = ArrayMesh(n_arrays) if n_arrays > 1 else None
    cache = ProgramCache(path=tmp_path / "cache.bin")

    def serve(faults=None):
        pre, dec = (ModelExecutable.for_cell("gemma-7b", shape, cfg,
                                             cache=cache, mesh=mesh)
                    for shape in ("prefill_tiny", "decode_tiny"))
        sched = Scheduler(pre, dec, max_concurrent=2, seed=7, faults=faults)
        for _ in range(3):
            sched.submit(decode_steps=4)
        rep = sched.run()
        return [r.state_checksum for r in rep.requests], rep

    base, base_rep = serve()
    injector = FaultInjector(FaultPlan.standard(0, n_arrays=n_arrays))
    sums, rep = serve(injector)
    assert sums == base and all(sums)
    assert injector.unrecovered() == 0
    assert all(r.status == "ok" for r in rep.requests)
    assert any(r.retries > 0 for r in rep.requests)
    if n_arrays == 1:
        assert set(injector.injected) == {"launch_transient", "launch_nan",
                                          "kv_exhaust", "cache_corrupt"}
    else:
        assert injector.injected.get("array_down") == 1
        assert (base_rep.n_arrays, rep.n_arrays) == (2, 1)
        assert rep.summary()["resilience"]["mesh_degraded"] == 1


# (B * KVH, g, D, skv, dv, longest length): the model zoo's decode
# attention in bf16, a request's GQA group as its query rows: gemma-7b
# (g = 1) and qwen2-72b (g = 8) at the serve's batch of 4 and cache of 49,
# and d, dv off the 8-element grid (element copies)
ZOO_DECODE_CASES = [(64, 1, 256, 49, 256, 47), (32, 8, 128, 49, 128, 33),
                    (3, 2, 20, 19, 28, 19)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,g,d,skv,dv,length", ZOO_DECODE_CASES)
def test_flash_decode_bf16_kernel_matches_plain(cuda, b, g, d, skv, dv,
                                                length):
    """The bf16 route against its plain version (p rounded to bf16 before
    P V, fp32 sums, output in bf16), ragged lengths down to 1, within a
    bf16 place (rtol and atol 1e-2)."""
    q = _t(_np((b, g, d)), cuda).to(torch.bfloat16)
    k = _t(_np((b, skv, d)), cuda).to(torch.bfloat16)
    v = _t(_np((b, skv, dv)), cuda).to(torch.bfloat16)
    lens = torch.tensor([max(1, length - 5 * (i % 10)) for i in range(b)],
                        dtype=torch.int32, device=cuda)
    before = fa.launches
    got = ops.flash_decode(q, k, v, lens, scale=d ** -0.5)
    want = ref.flash_decode_ref(q, k, v, lens, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, g, dv)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


#: the bf16 route's rows in ``chip_smoke.py`` phase 2: whisper-base's
#: cross attention (1500 keys, 8 ranges), MLA's absorbed decode (128 rows,
#: d 576, dv 512) and gemma-7b's self attention (B, sq, skv, d, dv,
#: length, scale)
BF16_ROUTE_CASES = [(32, 1, 1500, 64, 64, 1500, 64 ** -0.5),
                    (4, 128, 49, 576, 512, 47, 192 ** -0.5),
                    (64, 1, 49, 256, 256, 47, 256 ** -0.5)]


def _bf16_inputs(b, sq, skv, d, dv, scale, device):
    """q at 1/scale (peaked scores), k at 0.5, v at 2 (outputs far above
    the atol), in bf16."""
    q = _t(_np((b, sq, d)), device) / scale
    k = _t(_np((b, skv, d), 0.5), device)
    v = _t(_np((b, skv, dv), 2.0), device)
    return (x.to(torch.bfloat16) for x in (q, k, v))


def _bf16_close(got, want, d):
    """``chip_smoke.check``'s tolerance and one bf16 place more: rtol 2e-4
    + 2**-7, atol 2e-4 * d."""
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=2e-4 + 2 ** -7, atol=2e-4 * d)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,d,dv,length,scale", BF16_ROUTE_CASES)
def test_flash_decode_bf16_route_matches_plain(cuda, b, sq, skv, d, dv,
                                               length, scale):
    """The redesigned bf16 route at the shapes it was redesigned for,
    against the plain version and against the split plain version cut as
    the kernel cuts it (``decode_plan``, which the built kernel agrees
    with); one launch."""
    q, k, v = _bf16_inputs(b, sq, skv, d, dv, scale, cuda)
    lens = torch.full((b,), length, dtype=torch.int32, device=cuda)
    before = fa.launches
    got = fa.flash_decode(q, k, v, lens, scale=scale)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, dv)
    plan = fa.decode_plan(skv, d, dv, sq)
    assert fa.decode_plan_on_card(skv, d, dv, sq) == plan
    _bf16_close(got, ref.flash_decode_ref(q, k, v, lens, scale=scale), d)
    _bf16_close(got, ref.flash_decode_split_ref(
        q, k, v, lens, split=plan["split"], chunk=plan["chunk"],
        scale=scale), d)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,d,dv,lengths", [
    # 3 ranges of 128 keys (the last 44): lengths 0, 1, skv, one ending
    # inside the first range (the later two empty), one off the chunk
    (5, 1, 300, 64, 64, (0, 1, 300, 50, 173)),
    # two row groups, the second part full; MLA-like widths
    (3, 20, 300, 96, 64, (300, 129, 7)),
    # d and dv off the 8-element grid (element copies), 8 ranges of 64+
    (2, 3, 1000, 20, 28, (1000, 999)),
    # two strips of v (640 columns), one range
    (2, 2, 70, 64, 640, (70, 33)),
    # a long cache: 8 ranges of 512 keys, 5 chunks in flight
    (2, 4, 4096, 128, 128, (4096, 2500)),
])
def test_flash_decode_bf16_route_shapes(cuda, b, sq, skv, d, dv, lengths):
    """Ragged lengths (0, 1, skv), skv off the chunk and off the range,
    empty ranges, row groups past 16, element copies, strips, long
    caches: the kernel against the plain version; a request of length 0
    gives zeros."""
    q, k, v = _bf16_inputs(b, sq, skv, d, dv, d ** -0.5, cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    got = fa.flash_decode(q, k, v, lens, scale=d ** -0.5)
    torch.cuda.synchronize()
    plan = fa.decode_plan(skv, d, dv, sq)
    assert fa.decode_plan_on_card(skv, d, dv, sq) == plan
    _bf16_close(got, ref.flash_decode_ref(q, k, v, lens, scale=d ** -0.5),
                d)
    if 0 in lengths:
        assert not got[list(lengths).index(0)].float().any()


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,d,dv,length,scale", BF16_ROUTE_CASES)
def test_flash_decode_bf16_route_rows_independent_of_batch(
        cuda, b, sq, skv, d, dv, length, scale):
    """A row's output is the same bits whether its request comes alone or
    in a batch of 32 (the cut depends on skv alone), and two calls agree
    bit for bit."""
    n = 32
    q, k, v = _bf16_inputs(n, sq, skv, d, dv, scale, cuda)
    lens = torch.tensor([length - i % 3 for i in range(n)],
                        dtype=torch.int32, device=cuda)
    both = fa.flash_decode(q, k, v, lens, scale=scale)
    again = fa.flash_decode(q, k, v, lens, scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(both, again)
    for r in (0, 5, n - 1):
        alone = fa.flash_decode(q[r:r + 1].contiguous(),
                                k[r:r + 1].contiguous(),
                                v[r:r + 1].contiguous(), lens[r:r + 1],
                                scale=scale)
        assert torch.equal(alone[0], both[r]), r


@pytest.mark.cuda
def test_flash_decode_bf16_route_raises_on_what_it_cannot_take(cuda):
    """A head too wide for one chunk in a block's shared memory is refused
    by the launch and raised: no fallback."""
    q = torch.zeros((1, 1, 8192), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((1, 16, 8192), dtype=torch.bfloat16, device=cuda)
    lens = torch.full((1,), 16, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="flash_decode launch failed"):
        fa.flash_decode(q, k, k, lens)


def _chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
def test_flash_decode_fp32_kernel_is_the_kernel_before_bf16(cuda):
    """The fp32 route's outputs, on exact inputs, have the digests the
    kernel gave before its bf16 route was added: bit-equal."""
    cs = _chip_smoke()
    want = [cs.DECODE_F32_DIGESTS.get(c[:5]) for c in cs.DIGEST_CASES]
    assert cs.decode_digests(fa.flash_decode) == want


def _zoo_config(arch):
    import dataclasses
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config
    cfg = reduced(get_config(arch))
    if arch == "qwen2-72b":          # a GQA group of 4 query heads
        cfg = dataclasses.replace(cfg, num_heads=8, num_kv_heads=2)
    if arch == "zamba2-1.2b":        # two applications, a tail, N = 64
        cfg = dataclasses.replace(cfg, num_layers=5, ssm_state=64)
    return cfg


def _zoo_counts():
    return {"flash_attention": fa.attention_launches,
            "flash_decode": fa.launches, "mamba_scan": ms.launches}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-72b",
                                  "falcon-mamba-7b", "granite-moe-3b-a800m",
                                  "deepseek-v2-236b", "zamba2-1.2b",
                                  "whisper-base"])
def test_reduced_model_kernel_path_matches_its_cpu_path(cuda, arch):
    """A reduced model (fp32) on the card, its attention and scan in the
    kernels, against the same parameters on the CPU (the plain versions):
    prefill logits and cache, then a decode step's logits, within 2e-4 +
    2e-4 * |cpu|; each family's launches exact at prefill and at a
    decode step (``chip_smoke.zoo_launches``)."""
    from repro_torch.models import build_model
    from repro_torch.serve import expand_cache
    cfg = _zoo_config(arch)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 12)))
    kw = {}
    if cfg.family == "encdec":
        kw["frames"] = _np((2, cfg.frontend_len, cfg.d_model), 0.02)
    at_prefill, a_step = _chip_smoke().zoo_launches(cfg)

    def launched(run):
        before = _zoo_counts()
        out = run()
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in _zoo_counts().items()
                     if v != before[k]}
    want, cache_c = cpu.prefill(toks, **kw)
    (got, cache_g), n = launched(lambda: card.prefill(toks, **kw))
    assert n == at_prefill
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    for c, g in zip(_leaves(cache_c), _leaves(cache_g), strict=True):
        torch.testing.assert_close(g.cpu(), c, rtol=2e-4, atol=2e-4)
    cache_c, cache_g = (expand_cache(m, c, 2, 16) for m, c in
                        ((cpu, cache_c), (card, cache_g)))
    tok = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 1)))
    pos = torch.tensor([12, 9], dtype=torch.int32)
    want, _ = cpu.decode_step(tok, cache_c, pos)
    (got, _), n = launched(lambda: card.decode_step(tok, cache_g, pos))
    assert n == a_step
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the backward kernels and training on the card
# ---------------------------------------------------------------------------

#: the gradients against their plain versions: |err| within rtol * |want|
#: + frac * RMS(want).  bf16: both round an fp32 sum to bf16 (one ulp
#: apart at most); fp32: another sum order
GRAD_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2 ** -7, 1e-3)}


def _close_grads(got, want, dtype):
    rtol, frac = GRAD_TOL[dtype]
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype == dtype
        g, w = g.float(), w.float()
        rms = float(w.pow(2).mean().sqrt())
        assert bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= rtol * w.abs() + frac * rms).all()), \
            float((g - w).abs().max())


# (bh, s, sk, d, causal, kv_len): block-aligned and ragged sequences,
# every head-dim template (32 .. 256), a masked key tail, full attention
# with more keys than queries, and a head_dim (34) whose rows are not
# whole 16-byte chunks (element-wise staging in both dtypes)
ATTN_BWD_CASES = [
    (4, 128, 128, 64, True, 128), (2, 96, 96, 32, True, 90),
    (3, 70, 70, 96, False, 70), (2, 64, 64, 128, True, 50),
    (2, 40, 72, 192, False, 60), (1, 33, 33, 256, True, 33),
    (2, 16, 48, 64, False, 48), (2, 200, 200, 48, True, 200),
    (2, 45, 45, 34, True, 40),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,sk,d,causal,kv_len", ATTN_BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(cuda, bh, s, sk, d, causal,
                                                  kv_len, dtype):
    """The backward kernel against ``ref.flash_attention_bwd_ref`` on the
    same inputs (the forward kernel's o and lse); two runs torch.equal;
    the forward's o the same bits with and without lse."""
    q = _t(_np((bh, s, d), 2.0), cuda).to(dtype)
    k, v, do = (_t(_np(shape), cuda).to(dtype) for shape in
                ((bh, sk, d), (bh, sk, d), (bh, s, d)))
    o, lse = fa.flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                return_lse=True)
    assert torch.equal(o, fa.flash_attention(q, k, v, causal=causal,
                                             kv_len=kv_len))
    _, want_lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                          kv_len=kv_len, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    before = fa.attention_bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                 kv_len=kv_len)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.attention_bwd_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       kv_len=kv_len)
    _close_grads(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_masked_rows_give_zero(cuda, dtype):
    """kv_len 0 masks every key: lse +inf, the output and every gradient
    zero, none NaN."""
    q, k, v, do = (_t(_np((2, 40, 64)), cuda).to(dtype) for _ in range(4))
    o, lse = fa.flash_attention(q, k, v, causal=True, kv_len=0,
                                return_lse=True)
    assert bool(torch.isinf(lse).all()) and bool((lse > 0).all())
    assert not o.any()
    for g in fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                    kv_len=0):
        assert bool(torch.isfinite(g).all()) and not g.any()


#: the scan's backward cases: block-aligned and ragged lengths and
#: channel blocks, every state width's lane layout, D * N not a multiple of
#: 4 (element copies), three chunks and more
SCAN_BWD_CASES = SCAN_CASES + [
    (1, 37, 33, 16), (1, 37, 33, 64), (3, 17, 5, 1), (2, 50, 9, 2),
    (1, 16, 300, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,n", SCAN_BWD_CASES)
def test_mamba_scan_states_kernel_matches_plain(cuda, b, l, d, n):
    """The forward with ``return_states``: y and h_last torch.equal to
    the call without (the states are one more store), the states
    torch.equal to the plain version's (rounded multiplies and adds in
    both)."""
    da, dbx, c, h0 = (_t(a, cuda) for a in _scan_inputs(b, l, d, n))
    before = ms.launches
    y, h_last, states = ms.mamba_scan(da, dbx, c, h0, return_states=True)
    y0, h0_last = ms.mamba_scan(da, dbx, c, h0)
    torch.cuda.synchronize()
    assert ms.launches == before + 2
    assert torch.equal(y, y0) and torch.equal(h_last, h0_last)
    want = ref.mamba_scan_ref(da, dbx, c, h0, return_states=True)[2]
    assert states.shape == want.shape and torch.equal(states, want)


@pytest.mark.cuda
@pytest.mark.parametrize("given_states", [False, True])
@pytest.mark.parametrize("with_dh_last", [False, True])
@pytest.mark.parametrize("b,l,d,n", SCAN_BWD_CASES)
def test_mamba_scan_bwd_kernel_matches_plain(cuda, b, l, d, n,
                                             with_dh_last, given_states):
    """The backward kernel against ``ref.mamba_scan_bwd_ref``: dda, ddbx
    and dh0 bit-equal (rounded multiplies and adds in both, each chunk's
    states recomputed bit-equal from the forward's), dc within fp32
    tolerance (its sum over D in another order); two runs torch.equal.
    Given the forward's states (as training calls it) or not (the
    wrapper then launches the forward first, counted as a forward)."""
    da, dbx, c, h0 = (_t(a, cuda) for a in _scan_inputs(b, l, d, n))
    dy = _t(_np((b, l, d)), cuda)
    dh_last = _t(_np((b, d, n)), cuda) if with_dh_last else None
    states = (ms.mamba_scan(da, dbx, c, h0, return_states=True)[2]
              if given_states else None)
    before, before_fwd = ms.bwd_launches, ms.launches
    got = ms.mamba_scan_bwd(da, dbx, c, h0, dy, dh_last, states)
    again = ms.mamba_scan_bwd(da, dbx, c, h0, dy, dh_last, states)
    torch.cuda.synchronize()
    assert ms.bwd_launches == before + 2
    assert ms.launches == before_fwd + (0 if given_states else 2)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    want = ref.mamba_scan_bwd_ref(da, dbx, c, h0, dy, dh_last)
    for i in (0, 1, 3):
        assert torch.equal(got[i], want[i]), i
    torch.testing.assert_close(got[2], want[2], rtol=2e-4, atol=2e-4 * d)


@pytest.mark.cuda
def test_mamba_scan_states_are_dropped_under_checkpoint(cuda):
    """Layers of ``ops.mamba_scan`` under non-reentrant
    ``torch.utils.checkpoint``, as ``Model.loss`` runs its blocks: what
    the forward leaves alive grows by each layer's output (the next
    layer's saved input), not by its states, which go through
    ``save_for_backward`` and so are dropped and rebuilt in the
    recompute; the backward then runs the kernels and gives finite
    gradients."""
    from torch.utils.checkpoint import checkpoint
    b, seq, d, n, layers = 4, 256, 64, 64, 4
    gen = torch.Generator(cuda).manual_seed(0)
    w = [(torch.randn(d, n, device=cuda, generator=gen) + 2.0
          ).requires_grad_() for _ in range(layers)]
    bm = torch.randn(b, seq, n, device=cuda, generator=gen) * 0.1
    c = torch.randn(b, seq, n, device=cuda, generator=gen)
    h0 = torch.zeros(b, d, n, device=cuda)

    def layer(x, wi):
        da = torch.sigmoid(wi).expand(b, seq, d, n)
        return ops.mamba_scan(da, x[..., None] * bm[:, :, None, :], c,
                              h0)[0]

    x = torch.randn(b, seq, d, device=cuda, generator=gen).requires_grad_()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    h = x
    for wi in w:
        h = checkpoint(layer, h, wi, use_reentrant=False)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - start
    out_bytes = 4 * b * seq * d
    states_bytes = 4 * b * (seq // ref.SCAN_CHUNK) * d * n
    assert grown < layers * (out_bytes + states_bytes // 2), (grown,
                                                             states_bytes)
    before = ms.bwd_launches
    h.pow(2).sum().backward()
    torch.cuda.synchronize()
    assert ms.bwd_launches == before + layers
    assert all(bool(torch.isfinite(t.grad).all()) for t in [x, *w])


@pytest.mark.cuda
def test_ops_gradients_on_the_card_match_the_cpu(cuda):
    """``ops.flash_attention`` (GQA-repeated heads, ragged lengths padded
    and cut, MLA's narrower values) and ``ops.mamba_scan`` (N padded 48 ->
    64, Mamba-2's expanded da) differentiated on the card through the
    backward kernels, against the CPU's plain forward and backward, fp32:
    every input's gradient within 2e-4 + 2e-4 * |cpu|."""
    def grads(fn, arrays, device):
        ts = [_t(a, device).requires_grad_() for a in arrays]
        outs = fn(*ts)
        outs = outs if isinstance(outs, tuple) else (outs,)
        seeds = [_t(_np(tuple(o.shape)), device) for o in outs]
        torch.autograd.backward(outs, seeds)
        return [t.grad.cpu() for t in ts]

    for fn, arrays in (
            (lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
             _attn_inputs(2, 45, 3, 64)),
            (lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
             (_np((2, 20, 2, 48), 0.3), _np((2, 20, 2, 48), 0.3),
              _np((2, 20, 2, 32)))),
            (lambda q, k, v: ops.flash_attention(q, k, v, causal=False),
             (_np((1, 9, 2, 16), 0.3), _np((1, 30, 2, 16), 0.3),
              _np((1, 30, 2, 16)))),
            (lambda *a: ops.mamba_scan(*a), _scan_inputs(2, 21, 10, 48)),
            (lambda *a: ops.mamba_scan(*a)[0], _scan_inputs(2, 21, 10, 64))):
        state = RNG.bit_generator.state
        cpu = grads(fn, arrays, "cpu")
        RNG.bit_generator.state = state
        card = grads(fn, arrays, cuda)
        for g, w in zip(card, cpu, strict=True):
            torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_training_on_the_card_matches_the_cpu(cuda):
    """``launch.train`` on a reduced zamba2 (fp32; two applications of
    the shared block and a tail, N 64), 3 steps on the card through the
    forward and backward kernels against the same run on the CPU from
    the same parameters: the losses within 1e-4 relative, every
    parameter within 2e-4 + 2e-4 * |cpu|; the card's launches exact
    (``chip_smoke.train_launches``)."""
    from repro_torch.launch import train as launch_train
    cs = _chip_smoke()
    cfg = _zoo_config("zamba2-1.2b")
    argv = ["--arch", "zamba2-1.2b", "--batch", "2", "--seq", "24",
            "--steps", "3", "--lr", "1e-3", "--log-every", "100"]
    cpu, card = (launch_train.Run(launch_train.parse(argv + ["--device", d]),
                                  cfg) for d in ("cpu", "cuda"))
    card.model.load_state_dict(cpu.model.state_dict())
    card.opt_state = launch_train.optlib.init(
        dict(card.model.net.named_parameters()))
    losses = {}
    for name, run in (("cpu", cpu), ("cuda", card)):
        cs.reset_counts()
        losses[name] = []
        run.train(lambda step, m, out=losses[name]: out.append(
            float(m["loss"])))
    torch.cuda.synchronize()
    assert cs.counts() == cs.train_launches(cfg, 3)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    want = cpu.model.state_dict()
    for name, got in card.model.state_dict().items():
        torch.testing.assert_close(got.cpu(), want[name], rtol=2e-4,
                                   atol=2e-4)
