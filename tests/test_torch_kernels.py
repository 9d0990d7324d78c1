"""The port's kernels on the CPU: each plain PyTorch version against the
JAX package's Pallas kernel in interpret mode, on the same seeded numpy
inputs (rtol 2e-4, atol 2e-4 * k, the reference's ``cross_check``
tolerance).  The CUDA kernels themselves are held against these plain
versions on a card by ``test_torch_cuda.py``."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_cuda import (ATTN_CASES, CLUSTER_CASES, DECODE_CASES,
                             FUSED_CASES, NEST_CASES, PROJ_CASES, SCAN_CASES,
                             _attn_inputs, _decode_inputs, _fused_inputs,
                             _np, _proj_inputs, _scan_inputs, _t)

import jax.numpy as jnp

from repro.kernels import flash_attention as jfa
from repro.kernels import fused_chain as jfc
from repro.kernels import nest_gemm as jng
from repro.kernels import ops as jops
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_chain as fc
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import nest_gemm as ng

# ---------------------------------------------------------------------------
# plain versions == Pallas (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bk", [16, 128])
@pytest.mark.parametrize("m,k,n,out_t,act", NEST_CASES + [
    (16, 256, 100, False, "silu"),       # past 8 rows
    (31, 129, 64, True, "relu"),
    (32, 512, 256, True, None),
])
def test_nest_gemm_plain_matches_pallas(m, k, n, out_t, act, bk):
    x, w = _np((m, k)), _np((k, n), k ** -0.5)
    want = np.asarray(jops.nest_gemm(x, w, bk=bk, interpret=True,
                                     out_block_t=out_t, act=act))
    got = ops.nest_gemm(_t(x), _t(w), bk=bk, out_block_t=out_t,
                        act=act).numpy()
    assert got.shape == want.shape == ((n, m) if out_t else (m, n))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 * k)


@pytest.mark.parametrize("dims,bm,bks,acts,adapts", FUSED_CASES + [
    CLUSTER_CASES[4],                    # the 64-row synthetic chain
])
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


def _from_jnp(x, dtype):
    """The exact values of a (possibly bf16) JAX array as a torch tensor."""
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


@pytest.mark.parametrize("qshape,skv,lengths,bkv", DECODE_CASES + [
    ((6, 8, 32), 40, (40, 33, 1, 17, 0, 9), 16),   # a GQA group of 8 rows
])
def test_flash_decode_bf16_plain_matches_pallas(qshape, skv, lengths, bkv):
    """bf16 operands, as the model's cache holds them: the TPU kernel
    scores with fp32 sums, rounds p to v's dtype before P V and stores in
    q's dtype; the plain version does the same (on these inputs the two
    are equal).  rtol and atol 1e-3 take no bf16 place of an output above
    0.5, so p left in fp32 (off by 0.004 to 0.008 here) would fail."""
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16)
                  for a in _decode_inputs(qshape, skv))
    lens = np.asarray(lengths, np.int32)
    want = jops.flash_decode(jq, jk, jv, lens, bkv=bkv, interpret=True)
    assert want.dtype == jnp.bfloat16
    tq, tk, tv = (_from_jnp(x, torch.bfloat16) for x in (jq, jk, jv))
    got = ops.flash_decode(tq, tk, tv, lens, bkv=bkv)
    assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-3,
                               atol=1e-3)
    # the fp32 path of the same function is unchanged: fp32 in, fp32 out
    f32 = ops.flash_decode(tq.float(), tk.float(), tv.float(), lens,
                           bkv=bkv)
    assert f32.dtype == torch.float32
    if 0 in lengths:
        assert not got[list(lengths).index(0)].float().any()


#: the split plain version's cases: skv 300 in 4 ranges of 80 keys, each
#: in chunks of 32 (a range ends inside its third chunk); lengths 0, 1,
#: 50 (it ends inside the first range: the later three are empty), 173
#: (inside the third) and 300; one query row or a row group of 16; d 64
#: with dv 64, and d 96 with dv 64 (MLA's wider keys)
SPLIT_LENGTHS = (0, 1, 50, 300, 173)
SPLIT_CASES = [(sq, d, dv) for sq in (1, 16) for d, dv in ((64, 64),
                                                           (96, 64))]


def _split_inputs(sq, d, dv, dtype):
    """Seeded numpy q, k, v (skv 300) in ``dtype`` as JAX arrays, and the
    same values as torch tensors."""
    rng = np.random.default_rng(sq * 1000 + d)
    b, skv = len(SPLIT_LENGTHS), 300
    arrays = (rng.standard_normal((b, sq, d)),
              rng.standard_normal((b, skv, d)) * 0.5,
              rng.standard_normal((b, skv, dv)))
    jax_arrays = [jnp.asarray(a.astype(np.float32), getattr(jnp, dtype))
                  for a in arrays]
    return jax_arrays, [_from_jnp(x, getattr(torch, dtype))
                        for x in jax_arrays]


#: (rtol, atol) of the split version against the JAX kernel and against
#: the unsplit plain version: fp32 at the reference's 2e-4 (atol 2e-4 * d),
#: bf16 within a bf16 place (1e-2, the card tests' bf16 tolerance): the
#: ranges round p to bf16 against their own running maxima
SPLIT_TOL = {"float32": lambda d: (2e-4, 2e-4 * d),
             "bfloat16": lambda d: (1e-2, 1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,d,dv", SPLIT_CASES)
def test_flash_decode_split_plain_matches_pallas(sq, d, dv, dtype):
    """The bf16 route's plain version, the keys in 4 ranges merged in
    order, against the JAX ``flash_decode`` in interpret mode on the same
    inputs (v zero-padded to d for the JAX kernel, which takes one width,
    and its output cut back to dv); a request of length 0 gives zeros."""
    (jq, jk, jv), (tq, tk, tv) = _split_inputs(sq, d, dv, dtype)
    lens = np.asarray(SPLIT_LENGTHS, np.int32)
    jvp = jnp.concatenate([jv, jnp.zeros((*jv.shape[:2], d - dv),
                                         jv.dtype)], -1)
    want = np.asarray(jops.flash_decode(jq, jk, jvp, lens, bkv=64,
                                        interpret=True),
                      np.float32)[..., :dv]
    got = ref.flash_decode_split_ref(tq, tk, tv, torch.from_numpy(lens),
                                     split=80, chunk=32)
    assert got.dtype == tq.dtype and got.shape == (len(lens), sq, dv)
    rtol, atol = SPLIT_TOL[dtype](d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    assert not got[0].float().any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,d,dv", SPLIT_CASES)
def test_flash_decode_split_plain_matches_the_unsplit(sq, d, dv, dtype):
    """The split version against ``flash_decode_ref`` (one recurrence
    over every key); with one range holding every key it is that
    recurrence bit for bit."""
    _, (tq, tk, tv) = _split_inputs(sq, d, dv, dtype)
    lens = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32)
    want = ref.flash_decode_ref(tq, tk, tv, lens, bkv=32)
    got = ref.flash_decode_split_ref(tq, tk, tv, lens, split=80, chunk=32)
    rtol, atol = SPLIT_TOL[dtype](d)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    whole = ref.flash_decode_split_ref(tq, tk, tv, lens, split=320,
                                       chunk=32)
    assert torch.equal(whole, want)


def test_flash_decode_bf16_plan_depends_on_skv_alone():
    """The bf16 route's cut: whisper's cross attention (1500 keys) in 8
    ranges of 192, the zoo's and MLA's 49 keys in one (MLA's wide rows in
    chunks of 32, two in flight, its 512 columns one strip; gemma's one
    query row in strips of 128), a long cache in 8 ranges; the ranges the
    same at any d, dv and sq, and never past a block's shared memory."""
    assert fa.decode_plan(1500, 64, 64, 1) == dict(
        split=192, n_split=8, chunk=64, stages=3, dp=64, dvp=64, strip=128,
        strips=1, smem=60416)
    zoo = fa.decode_plan(49, 256, 256, 1)
    assert (zoo["n_split"], zoo["chunk"], zoo["stages"], zoo["strips"]) \
        == (1, 64, 1, 2)
    mla = fa.decode_plan(49, 576, 512, 128)
    assert (mla["n_split"], mla["chunk"], mla["stages"], mla["strips"]) \
        == (1, 32, 2, 1)
    assert fa.decode_plan(32768, 128, 128, 8)["n_split"] == 8
    assert fa.decode_plan(300, 64, 64, 1)["split"] == 128
    assert fa.decode_plan(1, 64, 64, 1)["n_split"] == 1
    shapes = ((64, 64, 1), (256, 256, 1), (576, 512, 128), (20, 28, 3),
              (1024, 1024, 16))
    for skv in (1, 49, 129, 300, 1500, 4096, 32768):
        plans = [fa.decode_plan(skv, d, dv, sq) for d, dv, sq in shapes]
        assert len({(p["split"], p["n_split"]) for p in plans}) == 1
        assert all(p["smem"] <= 232448 for p in plans)


@pytest.mark.parametrize("b,sq,skv,d,lengths,m_out,k_out,n_out",
                         PROJ_CASES)
def test_flash_decode_proj_plain_matches_pallas(b, sq, skv, d, lengths,
                                                m_out, k_out, n_out):
    q, k, v, wo = _proj_inputs(b, sq, skv, d, k_out, n_out)
    lens = np.asarray(lengths, np.int32)
    want = np.asarray(jops.flash_decode_proj(q, k, v, wo, lens,
                                             m_out=m_out, k_out=k_out,
                                             interpret=True))
    got = ops.flash_decode_proj(_t(q), _t(k), _t(v), _t(wo), lens,
                                m_out=m_out, k_out=k_out).numpy()
    assert got.shape == want.shape == (b, m_out, n_out)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 2e-5, 2e-4),
                                             ("bfloat16", 2e-2, 2e-1)])
@pytest.mark.parametrize("b,s,h,d,causal", ATTN_CASES)
def test_flash_attention_plain_matches_pallas(b, s, h, d, causal, dtype,
                                              rtol, atol):
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype))
                  for a in _attn_inputs(b, s, h, d))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                           interpret=True), np.float32)
    tq, tk, tv = (_from_jnp(x, getattr(torch, dtype)) for x in (jq, jk, jv))
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("s,sk,d", [(5, 37, 16), (64, 200, 32),
                                    (33, 2, 64), (96, 130, 16)])
def test_flash_attention_noncausal_padded_kv_plain_matches_pallas(s, sk, d):
    """Cross-attention with a key length off the block grid: the padded
    keys are masked through ``kv_len``."""
    q, k, v = _attn_inputs(1, s, 2, d, sk)
    want = np.asarray(jops.flash_attention(q, k, v, causal=False,
                                           interpret=True))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False).numpy()
    assert got.shape == want.shape == (1, s, 2, d)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_flash_attention_blockaligned_kv_len_plain_matches_pallas():
    """A block-aligned kv_len shorter than the padded buffer: poisoned
    padding leaks into neither version."""
    bh, s, d, real_kv = 2, 64, 32, 64
    q, k, v = _np((bh, s, d), 0.3), _np((bh, real_kv, d), 0.3), \
        _np((bh, real_kv, d))
    poison = np.full((bh, 64, d), 100.0, np.float32)
    k_pad, v_pad = (np.concatenate([x, poison], 1) for x in (k, v))
    want = np.asarray(jfa.flash_attention(q, k_pad, v_pad, causal=False,
                                          bq=32, bkv=64, kv_len=real_kv,
                                          interpret=True))
    got = ref.flash_attention_ref(_t(q), _t(k_pad), _t(v_pad),
                                  causal=False, bq=32, bkv=64,
                                  kv_len=real_kv).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    clean = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=False,
                                    bq=32, bkv=64).numpy()
    np.testing.assert_allclose(got, clean, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,l,d,n", SCAN_CASES)
def test_mamba_scan_plain_matches_pallas(b, l, d, n):
    da, dbx, c, h0 = _scan_inputs(b, l, d, n)
    y_want, h_want = jops.mamba_scan(da, dbx, c, h0, interpret=True)
    y, h = ops.mamba_scan(_t(da), _t(dbx), _t(c), _t(h0))
    assert y.shape == (b, l, d) and h.shape == (b, d, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), rtol=1e-4,
                               atol=1e-4)


def test_new_kernel_launchers_refuse_cpu_tensors():
    """The three kernels of this slice never fall back either."""
    before = (fa.proj_launches, fa.attention_launches, ms.launches)
    q, lens = torch.ones(1, 1, 4), torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_decode_proj(q, q, q, lens, torch.ones(4, 2), m_out=1,
                             k_out=4)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    x = torch.ones(1, 2, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan(x, x, torch.ones(1, 2, 4), torch.ones(1, 3, 4))
    assert (fa.proj_launches, fa.attention_launches, ms.launches) == before


def test_flash_decode_proj_shared_memory_groups():
    """The wrapper keeps every request's context in its clusters' shared
    memory (4 ranks, each holding as many as fit) when they fit and takes
    them in groups when not; one that cannot fit at all is refused before
    any launch."""
    assert fa.proj_group(4, 16, 256, 256) == 4       # the main path
    assert fa.proj_group(20, 4, 1024, 1024) == 16    # 4 contexts a rank
    with pytest.raises(ValueError, match="shared memory"):
        fa.proj_group(1, 64, 1024, 1024)


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
    kernel's: adapts force one M block of every row."""
    dims = ((16, 32, 48), (16, 48, 64), (16, 64, 24))
    assert fc.geometry(dims, 8, (16, 16, 32), (False,) * 3) \
        == (8, 2, (16, 16, 32), 64, 64)
    dims = ((4, 24, 32), (8, 16, 20), (8, 20, 12))
    assert fc.geometry(dims, 4, (8, 32, 8), (False, True, False)) \
        == (8, 1, (8, 16, 8), 24, 32)
    acts = (None, "softmax", None)
    assert fc.placement(dims, 4, (8, 32, 8), (False, True, False),
                        acts) == "shared"
    dims, bks, acts = CLUSTER_CASES[4][:1] + CLUSTER_CASES[4][2:4]
    assert fc.placement(dims, 64, bks, (False,) * 3, acts) == "shared-slab"


@pytest.mark.parametrize("n", [1, 3, 7, 12, 16, 20, 52, 64, 100, 255, 256,
                               512, 4097])
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_fused_column_slices_partition_each_layer(n, cs):
    """Every column of a layer belongs to exactly one rank, each rank's
    columns are contiguous and in rank order, and the kernel's chunk
    gives the same slices (c0 = min(n, r * chunk))."""
    slices = fc.column_slices(n, cs)
    assert len(slices) == cs
    owner = [r for r, (c0, c1) in enumerate(slices) for _ in range(c0, c1)]
    assert owner == sorted(owner) and len(owner) == n
    assert all(c0 <= c1 for c0, c1 in slices)
    assert [c for c0, c1 in slices for c in range(c0, c1)] == list(range(n))
    chunk = fc.rank_chunk(n, cs)
    assert chunk % 4 == 0 and chunk * cs >= n
    for r, (c0, c1) in enumerate(slices):
        assert c0 == min(n, r * chunk) and c1 - c0 == min(chunk, n - c0)


def test_fused_cluster_size_follows_the_widest_layer():
    """At least 16 columns of the widest layer a rank, up to 16 ranks
    (the H100's largest cluster); the rows do not change it."""
    assert [fc.cluster_size(n) for n in (1, 16, 17, 64, 96, 256, 512,
                                         4096)] == [1, 1, 2, 4, 8, 16, 16, 16]
    for dims, bm, bks, acts, adapts in FUSED_CASES + CLUSTER_CASES:
        p = fc.plan(dims, bm, bks, adapts, acts)
        assert p.cs == fc.cluster_size(max(d[2] for d in dims))
        assert p.chunks == tuple(fc.rank_chunk(d[2], p.cs) for d in dims)


def _smoke_fused_cases():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import fused_cases
    from repro_torch.configs.feather import feather_config
    from repro_torch.runtime import ModelExecutable, ProgramCache
    cache = ProgramCache()
    pre, dec = (ModelExecutable.for_cell("gemma-7b", shape,
                                         feather_config(4, 16), cache=cache)
                for shape in ("prefill_tiny", "decode_tiny"))
    return fused_cases(dec, pre, 4)


def test_fused_plans_of_the_smoke_cases():
    """Each fused_chain case of chip_smoke.py gets the plan its design
    says: the reduced cell's segments and the synthetic adapt chain keep
    weights and buffers in shared memory, the 64-row chain its buffers
    only, and the 256-row prefill geometry a global scratch; every
    placement is reached, and no block asks for more than 227 KB."""
    want = {"decode@4": "shared", "prefill": "shared",
            "synthetic adapt+row-wise": "shared",
            "synthetic 64-row": "shared-slab", "prefill@8 greedy": "global"}
    seen = set()
    for label, dims, bm, bks, acts, adapts in _smoke_fused_cases():
        p = fc.plan(dims, bm, bks, adapts, acts)
        assert p.placement == want[label], (label, p)
        assert p.smem_bytes <= fc.SMEM_LIMIT == 227 * 1024
        assert p.cs == 16 or label.startswith(("prefill", "synthetic"))
        seen.add(p.placement)
    assert seen == set(fc.PLACEMENTS)
    assert {fc.plan(d, bm, bks, ad, acts).placement
            for d, bm, bks, acts, ad in CLUSTER_CASES} == set(fc.PLACEMENTS)


def test_fused_plan_buffers_hold_every_layer():
    """A rank's slab holds the segment input and every later layer's
    input, its rows buffer every layer that needs whole rows, its
    accumulator every layer's slice, its weight stage every layer's slice
    ("shared") or the largest ("shared-slab"), all on float4 boundaries."""
    for dims, bm, bks, acts, adapts in FUSED_CASES + CLUSTER_CASES:
        p = fc.plan(dims, bm, bks, adapts, acts)
        assert p.slab_ld >= max(d[1] for d in dims)
        for l, d in enumerate(dims):
            gathers = acts[l] in fc.ROW_ACTS or (
                l + 1 < len(dims) and adapts[l + 1])
            assert not gathers or p.rows_ld >= d[2]
            assert p.acc_ld >= p.chunks[l]
        slices = [d[1] * c for d, c in zip(dims, p.chunks)]
        if p.placement == "shared":
            assert p.stage_floats == sum(slices)
            assert list(p.w_offs) == [sum(slices[:l])
                                      for l in range(len(dims))]
        else:
            assert set(p.w_offs) == {0}
            assert p.stage_floats == (max(slices)
                                      if p.placement == "shared-slab" else 0)
        ints = p.ints(dims[-1][0])
        assert all(v % 4 == 0 for v in (p.slab_ld, p.rows_ld, p.acc_ld,
                                        *ints[7:10], *p.w_offs))
        assert ints[11] * 4 == (p.smem_bytes or 4 * p.rank_floats)


def test_fused_launch_args_are_the_plan_once_per_configuration():
    """The wrapper's launch arrays, built once per configuration, are the
    plan's: a repeat call returns the same objects."""
    for dims, bm, bks, acts, adapts in FUSED_CASES + CLUSTER_CASES:
        args = (tuple(dims), bm, tuple(bks), tuple(adapts), tuple(acts))
        p, layers, ints = fc._launch_args(*args)
        assert p == fc.plan(dims, bm, bks, adapts, acts)
        assert list(ints) == p.ints(dims[-1][0])
        for l, d in enumerate(dims):
            assert list(layers[8 * l:8 * l + 8]) == [
                *d, p.bks[l], fc.ACT_CODES[acts[l]], int(adapts[l]),
                p.chunks[l], p.w_offs[l]]
        again = fc._launch_args(*args)
        assert again[1] is layers and again[2] is ints


@pytest.mark.parametrize("m,k,n,ptr,floats", [
    (8, 3072, 256000, 0, 0),                 # decode rows
    (16, 3072, 256000, 0, 0),                # row blocks of 32
    (32, 24576, 3072, 0, 0),                 # a narrow weight
    (32, 3072, 256000, 0, 64 * 48 * 32),     # lm_head: chunks of 48
    (32, 3072, 24576, 4, 0),                 # w not 16-byte aligned
    (31, 300, 8200, 0, 64 * 16 * 32),        # chunks of 16
    (33, 1000, 24574, 0, 0),                 # N not a multiple of 4
    (64, 24576, 8192, 0, 2 * 64 * 384 * 32),  # two row blocks
])
def test_nest_gemm_scratch_only_on_the_wide_path(m, k, n, ptr, floats):
    """Only the wide-weight path (past 16 rows, N >= 8192 in float4
    columns) takes scratch, for X laid out group-major in row blocks of
    32 with each group's k padded to whole chunks: a decode call
    allocates nothing beside its output."""
    assert ng.scratch_floats(m, k, n, ptr) == floats


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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: integer ops on the bits."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def test_three_tf32_products_keep_fp32_accuracy():
    """Why ``csrc/flash_attention.cu`` takes three tensor-core products for
    fp32 scores: at the smoke statistics (q at 8x, d 256, a few hundred
    keys), split a = hi + lo with hi = tf32(a), lo = tf32(a - hi); the sum
    lo*hi + hi*lo + hi*hi (each product exact, as the tensor cores form
    it) stays within 1e-5 of the float64 Q K^T, relative to sum |q||k|,
    and one TF32 product (hi*hi) does not."""
    rng = np.random.default_rng(14)
    q = torch.from_numpy((rng.standard_normal((64, 256)) * 8.0)
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((300, 256)).astype(np.float32))
    assert torch.equal(_tf32(torch.tensor([1 + 2 ** -11, -1 - 2 ** -11,
                                           1 + 2 ** -12])),
                       torch.tensor([1 + 2 ** -10, -1 - 2 ** -10, 1.0]))
    qh, kh = _tf32(q), _tf32(k)
    ql, kl = _tf32(q - qh), _tf32(k - kh)
    assert torch.equal(_tf32(qh), qh) and torch.equal(_tf32(ql), ql)

    def mm(a, b):
        return a.double() @ b.double().T
    exact = mm(q, k)
    scale = mm(q.abs(), k.abs())
    three = mm(ql, kh) + mm(qh, kl) + mm(qh, kh)
    one = mm(qh, kh)
    assert float(((three - exact).abs() / scale).max()) <= 1e-5
    assert float(((one - exact).abs() / scale).max()) > 1e-5
