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

# (b, l, d, n): tests/test_kernels.py's mamba_scan grid
SCAN_CASES = [(2, 64, 32, 16), (1, 128, 64, 8), (2, 256, 16, 4)]


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
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-72b",
                                  "falcon-mamba-7b", "granite-moe-3b-a800m",
                                  "deepseek-v2-236b"])
def test_reduced_model_kernel_path_matches_its_cpu_path(cuda, arch):
    """A reduced model (fp32) on the card, its attention and scan in the
    kernels, against the same parameters on the CPU (the plain versions):
    prefill logits and cache, then a decode step's logits, within 2e-4 +
    2e-4 * |cpu|; one kernel launch a layer at prefill and a decode
    step."""
    from repro_torch.models import build_model
    from repro_torch.serve import expand_cache
    cfg = _zoo_config(arch)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 12)))
    ssm_family = cfg.family == "ssm"
    kernel, count = (ms, "launches") if ssm_family else \
        (fa, "attention_launches")
    before = getattr(kernel, count)
    want, cache_c = cpu.prefill(toks)
    got, cache_g = card.prefill(toks)
    torch.cuda.synchronize()
    assert getattr(kernel, count) == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)

    def leaves(cache):
        if ssm_family:
            return list(cache["layers"].values())
        return [t for key in sorted(cache) for t in cache[key]]
    for c, g in zip(leaves(cache_c), leaves(cache_g)):
        torch.testing.assert_close(g.cpu(), c, rtol=2e-4, atol=2e-4)
    cache_c, cache_g = (expand_cache(m, c, 2, 16) for m, c in
                        ((cpu, cache_c), (card, cache_g)))
    tok = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 1)))
    pos = torch.tensor([12, 9], dtype=torch.int32)
    kernel = ms if ssm_family else fa
    before = kernel.launches
    want, _ = cpu.decode_step(tok, cache_c, pos)
    got, _ = card.decode_step(tok, cache_g, pos)
    torch.cuda.synchronize()
    assert kernel.launches == before + cfg.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
