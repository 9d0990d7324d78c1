"""The port's encdec family (``repro_torch.models.encdec``, whisper-base)
against the JAX package's on the CPU.  Parameters are the JAX package's
init loaded with ``Model.load_numpy``; the inputs (tokens and the
frontend stub's frames) are seeded numpy; every output is held within
2e-4 + 2e-4 * |ref| (the parity contract's tolerance) in fp32.  The
encoder's and the cross attention run ``kernels.ops.flash_attention``'s
plain version, full, without rope; a decode step's self and cross
attention ``kernels.ops.flash_decode``'s.

In bf16 the port casts the frames to the model's dtype; the JAX package
keeps the frames' and refuses the serving CLI's fp32 frames (pinned
here), so it is given them cast to bf16."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import expand_cache as jexpand_cache
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model, common
from repro_torch.serve import Engine, ServeConfig, expand_cache
from test_torch_models import B, S, _normal, _rng, _t, close, np_tree, pair

ARCH = "whisper-base"


@functools.lru_cache(maxsize=None)
def bf16_pair():
    """(JAX model, its params, port model) for reduced whisper-base in
    bf16, the published dtype."""
    jm = jbuild_model(dataclasses.replace(jreduced(jget_config(ARCH)),
                                          dtype="bfloat16"))
    params = jm.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="bfloat16")
    return jm, params, build_model(cfg, device="cpu").load_numpy(
        np_tree(params))


def _frames(cfg, seed, batch=B):
    """The serving CLI's frames: fp32, scale 0.02."""
    return _normal(_rng(seed), (batch, cfg.frontend_len, cfg.d_model), 0.02)


def _close_cache(cache, jcache):
    for key in ("self", "cross"):
        for c, jc in zip(cache["layers"][key], jcache["layers"][key],
                         strict=True):
            # head-major [L, B, KVH, S, D] against [L, B, S, KVH, D]
            close(c.permute(0, 1, 3, 2, 4), jc)


def _rel(got, want) -> float:
    """The largest relative L2 distance of a row."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return float((np.linalg.norm(got - want, axis=-1)
                  / np.linalg.norm(want, axis=-1)).max())


def test_sinusoidal_matches():
    pos = _rng(21).integers(0, 3000, (3, 5)).astype(np.int32)
    close(common.sinusoidal_at(_t(pos), 64),
          jcommon.sinusoidal_at(jnp.asarray(pos), 64))
    close(common.sinusoidal_positions(1500, 512),
          jcommon.sinusoidal_positions(1500, 512))


def _layer(i=1):
    jm, params, model = pair(ARCH)
    jp = jax.tree.map(lambda a: a[i], params["dec_layers"])
    return jm.cfg, jp, model.net.dec_layers[i]


def test_full_attention_without_rope_matches():
    """``GQA.self_attention(causal=False, use_rope=False)``, the encoder's
    attention, and the decoder's causal one without rope."""
    cfg, jp, layer = _layer()
    x = _normal(_rng(22), (B, S, cfg.d_model))
    for causal in (False, True):
        jout, (jk, jv) = jattn.gqa_self_attention(
            jp["attn"], cfg, jnp.asarray(x), None, causal=causal,
            use_rope=False)
        out, (k, v) = layer.attn.self_attention(_t(x), None, causal=causal,
                                                use_rope=False)
        close(out, jout)
        close(k.transpose(1, 2), jk)
        close(v.transpose(1, 2), jv)


def test_decode_attention_without_rope_matches():
    cfg, jp, layer = _layer()
    rng = _rng(23)
    s_max, kvh, hd = 16, cfg.num_kv_heads, cfg.head_dim
    x = _normal(rng, (B, 1, cfg.d_model))
    ck, cv = (_normal(rng, (B, s_max, kvh, hd)) for _ in range(2))
    pos = np.array([9, 3], np.int32)
    jout, _ = jattn.gqa_decode_attention(
        jp["attn"], cfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), use_rope=False)
    tk, tv = (_t(c).permute(0, 2, 1, 3).contiguous() for c in (ck, cv))
    out, _ = layer.attn.decode_attention(_t(x), tk, tv, _t(pos),
                                         use_rope=False)
    close(out, jout)


def test_cross_attention_matches():
    """``_enc_kv`` and ``_cross_attend`` at prefill (the prompt against
    the encoder's frames) and at a decode step (one token against the
    cached K/V)."""
    cfg, jp, layer = _layer()
    rng = _rng(24)
    enc = _normal(rng, (B, cfg.frontend_len, cfg.d_model))
    for s in (S, 1):
        x = _normal(rng, (B, s, cfg.d_model))
        jk, jv = jencdec._enc_kv(jp["cross"], cfg, jnp.asarray(enc))
        want = jencdec._cross_attend(jp["cross"], cfg, jnp.asarray(x), jk, jv)
        out, (k, v) = layer.cross.cross_attention(_t(x), _t(enc))
        close(out, want)
        close(k.transpose(1, 2), jk)
        close(v.transpose(1, 2), jv)
        close(layer.cross.cross_decode(_t(x[:, :1]), k, v),
              want if s == 1 else jencdec._cross_attend(
                  jp["cross"], cfg, jnp.asarray(x[:, :1]), jk, jv))


def test_encode_matches():
    jm, params, model = pair(ARCH)
    frames = _frames(jm.cfg, 25)
    close(model.net.encode(_t(frames)),
          jencdec.encode(params, jm.cfg, jnp.asarray(frames), remat=False))


def test_prefill_and_decode_match():
    """Prefill logits and caches, then a decode step's logits and the
    cache it updates in place (self K/V written, cross K/V kept)."""
    jm, params, model = pair(ARCH)
    cfg = model.cfg
    toks = _rng(26).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(cfg, 27)
    jlogits, jcache = jm.prefill(params, jnp.asarray(toks),
                                 frames=jnp.asarray(frames))
    logits, cache = model.prefill(toks, frames=frames)
    close(logits, jlogits)
    _close_cache(cache, jcache)

    jcache = jexpand_cache(jm, jcache, B, S + 8)
    cache = expand_cache(model, cache, B, S + 8)
    tok = _rng(28).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([S, S - 3], np.int32)
    jd, jcache2 = jm.decode_step(params, jnp.asarray(tok), jcache,
                                 jnp.asarray(pos))
    d, cache2 = model.decode_step(tok, cache, torch.as_tensor(pos))
    close(d, jd)
    assert cache2 is cache
    _close_cache(cache2, jcache2)


def test_bf16_prefill_and_decode_near_the_reference():
    """bf16: the port given the CLI's fp32 frames, the JAX package the
    same frames cast to bf16.  bf16 rounds at other places in the two
    packages (the JAX package's dense attention casts its probabilities
    to bf16; the port's follows the Pallas kernel's fp32 online softmax),
    so the logits are held by rows' relative L2 within 2e-2, the card's
    gate (``chip_smoke.ZOO_LOGITS_TOL``): reduced whisper-base reads
    ~6e-3 at prefill and ~8e-3 at decode.  Every cache and the logits stay
    in bf16."""
    jm, params, model = bf16_pair()
    cfg = model.cfg
    toks = _rng(29).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = _frames(cfg, 30)
    jlogits, jcache = jm.prefill(params, jnp.asarray(toks),
                                 frames=jnp.asarray(frames, jnp.bfloat16))
    logits, cache = model.prefill(toks, frames=frames)
    assert logits.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for kv in cache["layers"].values()
               for t in kv)
    assert _rel(logits, jlogits) <= 2e-2

    jcache = jexpand_cache(jm, jcache, B, S + 8)
    cache = expand_cache(model, cache, B, S + 8)
    tok = _rng(31).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([S, S - 3], np.int32)
    jd, _ = jm.decode_step(params, jnp.asarray(tok), jcache,
                           jnp.asarray(pos))
    d, _ = model.decode_step(tok, cache, torch.as_tensor(pos))
    assert d.dtype == torch.bfloat16
    assert _rel(d, jd) <= 2e-2


def test_reference_bf16_prefill_refuses_fp32_frames():
    """Found in the reference: its bf16 whisper-base keeps the frames'
    dtype, so the CLI's fp32 frames make the encoder's output and the
    cross K/V fp32, the first cross attention promotes the residual
    stream, and the decoder's layer scan refuses the carry."""
    jm, params, model = bf16_pair()
    toks = np.zeros((B, S), np.int32)
    frames = _frames(model.cfg, 32)
    with pytest.raises(TypeError, match="carry"):
        jm.prefill(params, jnp.asarray(toks), frames=jnp.asarray(frames))
    logits, _ = model.prefill(toks, frames=frames)
    assert bool(torch.isfinite(logits).all())


def test_decode_is_consistent_with_prefill():
    """prefill(t[:n]) then decode(t[n]) gives prefill(t[:n+1])'s logits
    (rtol and atol 2e-3, ``tests/test_arch_smoke.py``'s)."""
    model = pair(ARCH)[2]
    toks = _rng(33).integers(0, model.cfg.vocab_size, (B, 12))
    frames = _frames(model.cfg, 34)
    full, _ = model.prefill(toks, frames=frames)
    _, cache = model.prefill(toks[:, :-1], frames=frames)
    cache = expand_cache(model, cache, B, 12)
    step, _ = model.decode_step(toks[:, -1:], cache,
                                torch.full((B,), 11, dtype=torch.int32))
    torch.testing.assert_close(step, full, rtol=2e-3, atol=2e-3)


def test_greedy_tokens_equal_the_reference_engine():
    jm, params, model = pair(ARCH)
    prompts = _rng(35).integers(0, model.cfg.vocab_size,
                                (3, 10)).astype(np.int32)
    frames = _frames(model.cfg, 36, batch=3)
    want = JEngine(jm, params, JServeConfig(max_len=19)).generate(
        prompts, 8, frames=jnp.asarray(frames))
    engine = Engine(model, ServeConfig(max_len=19), device="cpu")
    np.testing.assert_array_equal(engine.generate(prompts, 8, frames=frames),
                                  want)


def test_frames_go_to_the_encdec_family_only():
    model = pair(ARCH)[2]
    toks = np.zeros((B, S), np.int32)
    with pytest.raises(ValueError, match="needs frames"):
        model.prefill(toks)
    with pytest.raises(ValueError, match="takes no frames"):
        pair("gemma-7b")[2].prefill(toks, frames=_frames(model.cfg, 37))


def test_cache_spec_matches():
    """Self and cross K/V head-major, [L, B, KVH, S, D] and [L, B, KVH,
    frontend_len, D], against the JAX package's [L, B, S, KVH, D]."""
    spec = build_model(get_config(ARCH), device="meta").cache_spec(4, 49)
    jspec = jbuild_model(jget_config(ARCH)).cache_spec(4, 49)
    shapes = {"self": (6, 4, 8, 49, 64), "cross": (6, 4, 8, 1500, 64)}
    for key, shape in shapes.items():
        for got, want in zip(spec["layers"][key], jspec["layers"][key],
                             strict=True):
            n, b, s, kv, d = want.shape
            assert got.is_meta and tuple(got.shape) == (n, b, kv, s, d)
            assert tuple(got.shape) == shape and got.dtype == torch.bfloat16
