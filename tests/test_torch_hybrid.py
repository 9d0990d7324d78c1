"""The port's hybrid family (``repro_torch.models.hybrid``: Mamba-2 blocks
and a shared attention block, zamba2-1.2b) against the JAX package's on
the CPU.  Parameters are the JAX package's init loaded with
``Model.load_numpy``; the inputs are seeded numpy; every output is held
within 2e-4 + 2e-4 * |ref| (the parity contract's tolerance) in fp32.
The scan runs ``kernels.ops.mamba_scan``'s plain version, heads folded
into its batch; the JAX package's is a chunked associative scan."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import ssm as jssm
from repro.serve.engine import expand_cache as jexpand_cache
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model, common, ssm
from repro_torch.serve import expand_cache
from test_torch_models import (B, S, ZAMBA2_TAIL, _normal, _rng, _t, close,
                               np_tree, pair)

ARCH, TAIL = ZAMBA2_TAIL
CASES = [(), TAIL]


def _close_cache(cache, jcache):
    close(cache["mamba"]["conv"], jcache["mamba"]["conv"])
    close(cache["mamba"]["ssm"], jcache["mamba"]["ssm"])
    assert cache["mamba"]["ssm"].dtype == torch.float32
    for c, jc in zip(cache["kv"], jcache["kv"], strict=True):
        # head-major [n, B, KVH, S, D] against [n, B, S, KVH, D]
        close(c.permute(0, 1, 3, 2, 4), jc)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_block_matches(with_state):
    """One Mamba-2 block, a prompt or one step on a carried state: the
    output, the conv state and the fp32 scan state [B, H, P, N]."""
    jm, params, _ = pair(ARCH)
    cfg = jm.cfg
    jp = jax.tree.map(lambda a: a[1], params["mamba_layers"]["mamba"])
    # a_log, dt_bias and d_skip are constant at init: give them a spread
    rng = _rng(11)
    h = cfg.ssm_heads
    jp = {**jp, "a_log": _normal(rng, (h,), 0.5),
          "dt_bias": _normal(rng, (h,), 0.5),
          "d_skip": _normal(rng, (h,))}
    module = ssm.Mamba2(common.Maker("cpu", torch.float32, None), cfg)
    common.load_numpy(module, np_tree(jp))
    x = _normal(rng, (B, 1 if with_state else S, cfg.d_model))
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    state = jstate = None
    if with_state:
        jstate = {"conv": _normal(rng, (B, cfg.ssm_d_conv - 1, di + 2 * n)),
                  "ssm": _normal(rng, (B, h, di // h, n), 0.3)}
        state = {k: _t(v) for k, v in jstate.items()}
    jy, jnew = jssm.mamba2_block(jp, cfg, jnp.asarray(x), jstate)
    y, new = module(_t(x), state)
    close(y, jy)
    close(new["conv"], jnew["conv"])
    close(new["ssm"], jnew["ssm"])
    assert new["ssm"].dtype == torch.float32


@pytest.mark.parametrize("extra", CASES)
def test_prefill_and_decode_match(extra):
    """Prefill logits and caches (two applications and a tail with
    ``TAIL``), then a decode step's logits and the cache it updates in
    place."""
    jm, params, model = pair(ARCH, extra)
    cfg = model.cfg
    toks = _rng(12).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, jcache = jm.prefill(params, jnp.asarray(toks))
    logits, cache = model.prefill(toks)
    close(logits, jlogits)
    _close_cache(cache, jcache)

    jcache = jexpand_cache(jm, jcache, B, S + 8)
    cache = expand_cache(model, cache, B, S + 8)
    tok = _rng(13).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([S, S - 3], np.int32)
    jd, jcache2 = jm.decode_step(params, jnp.asarray(tok), jcache,
                                 jnp.asarray(pos))
    d, cache2 = model.decode_step(tok, cache, torch.as_tensor(pos))
    close(d, jd)
    assert cache2 is cache                    # updated in place
    _close_cache(cache2, jcache2)


def test_decode_is_consistent_with_prefill():
    """prefill(t[:n]) then decode(t[n]) gives prefill(t[:n+1])'s logits
    (rtol and atol 2e-3, ``tests/test_arch_smoke.py``'s), with a tail."""
    model = pair(ARCH, TAIL)[2]
    toks = _rng(14).integers(0, model.cfg.vocab_size, (B, 12))
    full, _ = model.prefill(toks)
    _, cache = model.prefill(toks[:, :-1])
    cache = expand_cache(model, cache, B, 12)
    step, _ = model.decode_step(toks[:, -1:], cache,
                                torch.full((B,), 11, dtype=torch.int32))
    torch.testing.assert_close(step, full, rtol=2e-3, atol=2e-3)


def test_bf16_logits_near_the_reference():
    """The published dtype: bf16 rounds at other places in the two
    packages (the JAX package's dense attention casts its probabilities
    to bf16, the port's follows the Pallas kernel's fp32 online softmax),
    so the logits are held by rows' relative L2 within 2e-2, the card's
    gate (``chip_smoke.ZOO_LOGITS_TOL``): reduced zamba2 reads ~1.4e-2."""
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH)), dtype="bfloat16")
    cfg = dataclasses.replace(reduced(get_config(ARCH)), dtype="bfloat16")
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu").load_numpy(np_tree(params))
    toks = _rng(16).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, _ = jm.prefill(params, jnp.asarray(toks))
    logits, cache = model.prefill(toks)
    assert logits.dtype == torch.bfloat16
    assert cache["mamba"]["ssm"].dtype == torch.float32
    want = np.asarray(jlogits, np.float32)
    got = logits.float().numpy()
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert rel.max() <= 2e-2, rel


def test_load_numpy_unstacks_every_stacked_axis():
    """``mamba_layers`` and ``app_norms`` are stacked in the JAX pytree;
    each member lands in its own module."""
    jm, params, _ = pair(ARCH, TAIL)
    tree = np_tree(params)
    rng = _rng(17)
    tree["app_norms"] = {"scale": _normal(rng, (2, jm.cfg.d_model))}
    cfg = dataclasses.replace(reduced(get_config(ARCH)), **dict(TAIL))
    model = build_model(cfg, device="cpu").load_numpy(tree)
    for i in range(2):
        close(model.net.app_norms[i].scale, tree["app_norms"]["scale"][i])
    for i in range(5):
        close(model.net.mamba_layers[i].mamba.w_in,
              tree["mamba_layers"]["mamba"]["w_in"][i])


def test_cache_spec_matches():
    """The states as the JAX package's; the shared block's K/V head-major
    [n_attn, B, KVH, S, D] against [n_attn, B, S, KVH, D]."""
    spec = build_model(get_config(ARCH), device="meta").cache_spec(4, 49)
    jspec = jbuild_model(jget_config(ARCH)).cache_spec(4, 49)
    for key in ("conv", "ssm"):
        got, want = spec["mamba"][key], jspec["mamba"][key]
        assert got.is_meta and tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[1] == str(want.dtype)
    assert tuple(spec["mamba"]["ssm"].shape) == (38, 4, 64, 64, 64)
    for got, want in zip(spec["kv"], jspec["kv"], strict=True):
        n, b, s, kv, d = want.shape
        assert tuple(got.shape) == (n, b, kv, s, d) == (6, 4, 32, 49, 64)
        assert got.dtype == torch.bfloat16
