"""The port's gradients against the JAX package's on the CPU: the plain
backward versions of the two kernels that carry gradients
(``kernels.ref.flash_attention_bwd_ref``, ``mamba_scan_bwd_ref``)
against ``jax.grad`` of the JAX package's plain kernels
(``repro/kernels/ref.py``), both autograd Functions of
``kernels.ops`` by ``torch.autograd.gradcheck`` in float64, and
``Model.loss`` with every parameter's gradient against
``jax.value_and_grad(model.loss)`` for a reduced arch of each family.
fp32 throughout, within 2e-4 + 2e-4 * |ref| (the parity contract's
tolerance); the inputs are seeded numpy."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from test_torch_models import close, np_tree, pair

#: one reduced arch of each family: dense, moe, moe with MLA and a leading
#: dense layer, vlm, ssm, hybrid, encdec
FAMILY_ARCHS = ["gemma-7b", "granite-moe-3b-a800m", "deepseek-v2-236b",
                "internvl2-26b", "falcon-mamba-7b", "zamba2-1.2b",
                "whisper-base"]
B, S = 2, 10


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test on one CPU thread: its ops are small, and with several
    pytest workers each using every core they run ~10x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _grads_torch(fn, arrays, seeds):
    """The gradients of sum(seed * out) for each output of ``fn`` with
    respect to each input, through the port's autograd Functions."""
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(s) for s in seeds])
    return [t.grad for t in ts]


# (bh, s, d, causal, kv_len): causal, full, a ragged key tail masked
ATTN_GRAD_CASES = [(3, 20, 16, True, 20), (2, 24, 32, False, 24),
                   (2, 16, 16, False, 11), (2, 16, 8, True, 13)]


@pytest.mark.parametrize("bh,s,d,causal,kv_len", ATTN_GRAD_CASES)
def test_flash_attention_backward_matches_jax_grad(bh, s, d, causal,
                                                    kv_len):
    """dq, dk, dv of ``ops.attention_core`` (blocks of 8, keys at or past
    ``kv_len`` masked) against ``jax.grad`` of ``flash_attention_ref`` on
    the first ``kv_len`` keys; the masked keys' gradients zero."""
    rng = _rng(bh * 100 + s)
    q, k, v, do = (_normal(rng, (bh, s, d)) for _ in range(4))

    def fn(q, k, v):
        return ops.attention_core(q, k, v, causal=causal, bq=8, bkv=8,
                                  kv_len=kv_len)
    dq, dk, dv = _grads_torch(fn, (q, k, v), (do,))

    def jloss(q, k, v):
        return jnp.sum(jref.flash_attention_ref(q, k, v, causal=causal)
                       * do)
    jq, jk, jv = jax.grad(jloss, (0, 1, 2))(q, k[:, :kv_len], v[:, :kv_len])
    close(dq, jq)
    close(dk[:, :kv_len], jk)
    close(dv[:, :kv_len], jv)
    assert not dk[:, kv_len:].any() and not dv[:, kv_len:].any()


@pytest.mark.parametrize("n", [16, 64])
def test_mamba_scan_backward_matches_jax_grad(n):
    """dda, ddbx, dc and dh0 of ``ops.mamba_scan`` (y and h_last both
    carrying a gradient) against ``jax.grad`` of ``mamba_scan_ref``."""
    rng = _rng(n)
    b, seq, d = 2, 9, 5
    da = rng.uniform(0.6, 0.99, (b, seq, d, n)).astype(np.float32)
    dbx, c, h0 = (_normal(rng, (b, seq, d, n), 0.3), _normal(rng, (b, seq, n)),
                  _normal(rng, (b, d, n), 0.3))
    dy, dh = _normal(rng, (b, seq, d)), _normal(rng, (b, d, n))
    got = _grads_torch(ops.mamba_scan, (da, dbx, c, h0), (dy, dh))

    def jloss(*args):
        y, h_last = jref.mamba_scan_ref(*args)
        return jnp.sum(y * dy) + jnp.sum(h_last * dh)
    want = jax.grad(jloss, (0, 1, 2, 3))(da, dbx, c, h0)
    for g, w in zip(got, want, strict=True):
        close(g, w)


def test_plain_backwards_need_no_output_gradient():
    """``mamba_scan_bwd_ref`` with dh_last None equals it with zeros; the
    autograd Function passes None when h_last is unused."""
    rng = _rng(3)
    da = rng.uniform(0.6, 0.99, (1, 6, 3, 4)).astype(np.float32)
    args = [torch.from_numpy(a) for a in
            (da, _normal(rng, (1, 6, 3, 4)), _normal(rng, (1, 6, 4)),
             _normal(rng, (1, 3, 4)), _normal(rng, (1, 6, 3)))]
    none = ref.mamba_scan_bwd_ref(*args)
    zero = ref.mamba_scan_bwd_ref(*args, torch.zeros(1, 3, 4))
    for a, z in zip(none, zero):
        assert torch.equal(a, z)


def _scan_arrays(rng, b, seq, d, n):
    return [torch.from_numpy(a) for a in (
        rng.uniform(0.6, 0.99, (b, seq, d, n)).astype(np.float32),
        _normal(rng, (b, seq, d, n), 0.3), _normal(rng, (b, seq, n)),
        _normal(rng, (b, d, n), 0.3))]


@pytest.mark.parametrize("seq", [1, 16, 17, 40])
def test_mamba_scan_ref_states_are_the_chunk_edges(seq):
    """``mamba_scan_ref(..., return_states=True)``: y and h_last
    torch.equal to the call without; the states torch.equal to those of
    a step-by-step scan at every ``SCAN_CHUNK``-th step (the state each
    chunk starts from: h0, h_15, h_31, ...)."""
    da, dbx, c, h0 = _scan_arrays(_rng(seq), 2, seq, 3, 8)
    y, h_last, states = ref.mamba_scan_ref(da, dbx, c, h0,
                                           return_states=True)
    y0, h0_last = ref.mamba_scan_ref(da, dbx, c, h0)
    assert torch.equal(y, y0) and torch.equal(h_last, h0_last)
    h, want = h0, []
    for t in range(seq):
        if t % ref.SCAN_CHUNK == 0:
            want.append(h)
        h = da[:, t] * h + dbx[:, t]
    assert states.shape == (2, -(-seq // ref.SCAN_CHUNK), 3, 8)
    assert torch.equal(states, torch.stack(want, 1))


@pytest.mark.parametrize("seq,with_dh_last", [(9, False), (33, False),
                                              (33, True), (48, True)])
def test_mamba_scan_bwd_ref_given_states_equals_the_replay(seq,
                                                           with_dh_last):
    """``mamba_scan_bwd_ref`` given the forward's states (each chunk's
    states recomputed from its first) torch.equal to it without (the
    states replayed from h0)."""
    rng = _rng(100 + seq)
    da, dbx, c, h0 = _scan_arrays(rng, 2, seq, 3, 8)
    dy = torch.from_numpy(_normal(rng, (2, seq, 3)))
    dh = torch.from_numpy(_normal(rng, (2, 3, 8))) if with_dh_last else None
    states = ref.mamba_scan_ref(da, dbx, c, h0, return_states=True)[2]
    given = ref.mamba_scan_bwd_ref(da, dbx, c, h0, dy, dh, states)
    replay = ref.mamba_scan_bwd_ref(da, dbx, c, h0, dy, dh)
    for a, b in zip(given, replay, strict=True):
        assert torch.equal(a, b)


def test_mamba_scan_backward_over_chunks_matches_jax_grad():
    """The gradients of ``ops.mamba_scan`` over three chunks of states
    (37 steps; the backward recomputes each chunk from the state the
    forward stored) against ``jax.grad`` of ``mamba_scan_ref``."""
    rng = _rng(37)
    da, dbx, c, h0 = (t.numpy() for t in _scan_arrays(rng, 2, 37, 5, 16))
    dy, dh = _normal(rng, (2, 37, 5)), _normal(rng, (2, 5, 16))
    got = _grads_torch(ops.mamba_scan, (da, dbx, c, h0), (dy, dh))

    def jloss(*args):
        y, h_last = jref.mamba_scan_ref(*args)
        return jnp.sum(y * dy) + jnp.sum(h_last * dh)
    want = jax.grad(jloss, (0, 1, 2, 3))(da, dbx, c, h0)
    for g, w in zip(got, want, strict=True):
        close(g, w)


def test_mamba_scan_function_saves_its_states_for_backward():
    """``ops.mamba_scan`` with a gradient saves the forward's states
    through ``save_for_backward`` (seen by saved-tensor hooks, as
    ``torch.utils.checkpoint`` sees them), not as a ctx attribute that
    the checkpoint's hooks would keep alive."""
    arrays = _scan_arrays(_rng(8), 2, 20, 3, 8)
    ts = [a.requires_grad_() for a in arrays]
    packed = []

    def pack(t):
        packed.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = ops.mamba_scan(*ts)
    assert (2, 2, 3, 8) in packed
    y.sum().backward()
    assert all(t.grad is not None for t in ts)


@pytest.mark.parametrize("causal,kv_len", [(True, 12), (False, 12),
                                           (True, 7), (False, 0)])
def test_flash_attention_function_gradcheck(causal, kv_len):
    """The attention Function in float64 (the plain versions sum in fp64
    for fp64 inputs): ``torch.autograd.gradcheck``; kv_len 0 masks every
    key (zero gradients, no NaN)."""
    rng = _rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 12, 8)))
               .requires_grad_() for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.attention_core(q, k, v, causal=causal, bq=8,
                                           bkv=8, kv_len=kv_len),
        (q, k, v))


def test_ops_flash_attention_gradcheck_padded_gqa():
    """``ops.flash_attention`` as the models call it: heads folded,
    ragged lengths padded and cut, a narrower value head zero-padded."""
    rng = _rng(5)
    q, k = (torch.from_numpy(rng.standard_normal((1, 11, 2, 8)))
            .requires_grad_() for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((1, 11, 2, 6))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention(q, k, v, causal=True), (q, k, v))


def test_mamba_scan_function_gradcheck():
    rng = _rng(6)
    da = torch.from_numpy(rng.uniform(0.5, 0.95, (2, 7, 3, 4))
                          ).requires_grad_()
    rest = [torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
            for shape in ((2, 7, 3, 4), (2, 7, 4), (2, 3, 4))]
    assert torch.autograd.gradcheck(ops.mamba_scan, (da, *rest))
    assert torch.autograd.gradcheck(lambda *a: ops.mamba_scan(*a)[0],
                                    (da, *rest))


def _batch(cfg, seed):
    rng = _rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = _normal(rng, (B, cfg.frontend_len, cfg.d_model),
                                   0.02)
    if cfg.family == "encdec":
        batch["frames"] = _normal(rng, (B, cfg.frontend_len, cfg.d_model),
                                  0.02)
    return batch


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_gradients_match(arch):
    """``Model.loss`` (with remat, as the JAX package's default) and every
    parameter's gradient (``Model.grad_tree``, in the JAX package's
    layout) against ``jax.value_and_grad(model.loss)``; the MoE's aux
    loss and the vlm's prefix cut included."""
    jm, params, model = pair(arch)
    batch = _batch(model.cfg, 7)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, jax.tree.map(jnp.asarray, batch))
    model.requires_grad_(True)
    try:
        model.zero_grad(set_to_none=True)
        loss, metrics = model.loss(batch)
        loss.backward()
        close(loss, jloss)
        for key in ("nll", "aux", "perplexity"):
            close(metrics[key], jmet[key])
        got = jax.tree_util.tree_flatten_with_path(model.grad_tree())[0]
        want = jax.tree_util.tree_flatten_with_path(np_tree(jgrads))[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.shape == w.shape, jax.tree_util.keystr(path)
            close(g, w)
    finally:
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)


def test_remat_changes_no_gradient():
    """Rematerialised and stored activations give the same gradients
    (hybrid: the Mamba blocks under ``checkpoint``, the shared block
    not)."""
    _, _, model = pair("zamba2-1.2b", (("num_layers", 5),))
    batch = _batch(model.cfg, 8)
    model.requires_grad_(True)
    try:
        out = []
        for remat in (True, False):
            model.zero_grad(set_to_none=True)
            loss, _ = model.loss(batch, remat=remat)
            loss.backward()
            out.append((loss.detach(), [p.grad.clone()
                                        for p in model.parameters()]))
        assert torch.equal(out[0][0], out[1][0])
        for a, b in zip(out[0][1], out[1][1]):
            assert torch.equal(a, b)
    finally:
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)


def test_numpy_tree_round_trips_the_jax_layout():
    """``Model.numpy_tree`` gives back the JAX package's pytree that
    ``load_numpy`` took: the same paths, shapes and values (the stacked
    axes restacked, ``dense_layers`` a list)."""
    _, params, model = pair("deepseek-v2-236b")
    got = jax.tree_util.tree_flatten_with_path(model.numpy_tree())[0]
    want = jax.tree_util.tree_flatten_with_path(np_tree(params))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
