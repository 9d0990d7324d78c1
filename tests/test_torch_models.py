"""The port's model zoo (``repro_torch.models``) against the JAX package's
(``repro.models``) on the CPU.  Parameters are the JAX package's init
(``jax.random.PRNGKey``), exported to numpy and loaded into the port
with ``Model.load_numpy``; every module and model output is held within
2e-4 + 2e-4 * |ref| (the parity contract's tolerance) on the same numpy
inputs.  The port's attention and scan go through ``kernels.ops``, whose
plain versions run here."""

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
from repro.models import mlp as jmlp
from repro.models import ssm as jssm
from repro.serve.engine import expand_cache as jexpand_cache
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model, common, mlp, ssm
from repro_torch.serve.engine import expand_cache

RTOL = ATOL = 2e-4
#: the reduced archs of the ported families: dense (GQA + bias, relu2),
#: vlm, ssm, moe (GQA; MLA with a leading dense layer and shared experts)
ARCHS = ["gemma-7b", "qwen2-72b", "minitron-4b", "internvl2-26b",
         "falcon-mamba-7b", "granite-moe-3b-a800m", "deepseek-v2-236b"]
#: reduced() keeps kv == heads; this case groups 4 query heads a KV head
GQA = ("qwen2-72b", (("num_heads", 8), ("num_kv_heads", 2)))
#: a dense config with MoE layers (geglu experts), as the JAX package runs
#: it
GEMMA_MOE = ("gemma-7b", (("num_experts", 4), ("experts_per_token", 2),
                          ("moe_d_ff", 96)))
CASES = [(a, ()) for a in ARCHS] + [GQA, GEMMA_MOE]
#: reduced() gives zamba2 2 blocks and attn_every 2: one application of
#: its shared block and no tail; 5 blocks give two and a tail block
ZAMBA2_TAIL = ("zamba2-1.2b", (("num_layers", 5),))
B, S = 2, 12


def close(got, want):
    """Within 2e-4 + 2e-4 * |want|, elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def pair(arch: str, extra: tuple = ()):
    """(JAX model, its params, port model with those params loaded) for
    the reduced config of ``arch`` with ``extra`` replaced."""
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **dict(extra))
    cfg = dataclasses.replace(reduced(get_config(arch)), **dict(extra))
    jm = jbuild_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu").load_numpy(np_tree(params))
    return jm, params, model


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_rmsnorm_and_layernorm_match():
    rng = _rng(1)
    x, scale, bias = (_normal(rng, (2, 5, 48), 3.0), _normal(rng, (48,)),
                      _normal(rng, (48,)))
    close(common.rmsnorm(_t(scale), _t(x)),
          jcommon.rmsnorm({"scale": scale}, jnp.asarray(x)))
    close(common.layernorm(_t(scale), _t(bias), _t(x)),
          jcommon.layernorm({"scale": scale, "bias": bias}, jnp.asarray(x)))


@pytest.mark.parametrize("head_dim,theta", [(16, 1e4), (32, 1e6)])
def test_rope_matches(head_dim, theta):
    rng = _rng(2)
    x = _normal(rng, (2, 7, 3, head_dim))
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    close(common.rope(_t(x), _t(pos), theta),
          jcommon.rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches(kind):
    jp = jmlp.mlp_params(jcommon.Maker(key=jax.random.PRNGKey(3)), 32, 80,
                         kind)
    module = mlp.MLP(common.Maker("cpu", torch.float32, None), 32, 80, kind)
    common.load_numpy(module, np_tree(jp))
    x = _normal(_rng(3), (2, 6, 32))
    close(module(_t(x)), jmlp.mlp(jp, jnp.asarray(x), kind))


def _gqa(extra):
    jm, params, model = pair("qwen2-72b", extra)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    return jm.cfg, jp, model.net.layers[0].attn


@pytest.mark.parametrize("extra", [(), GQA[1]])
def test_gqa_prefill_attention_matches(extra):
    """Causal prefill with QKV bias: the output and the cache's K/V (the
    port's head-major [b, kv, s, hd] against [b, s, kv, hd])."""
    cfg, jp, module = _gqa(extra)
    rng = _rng(4)
    x = _normal(rng, (B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jout, (jk, jv) = jattn.gqa_self_attention(jp, cfg, jnp.asarray(x),
                                              jnp.asarray(pos))
    out, (k, v) = module.self_attention(_t(x), _t(pos))
    close(out, jout)
    close(k.transpose(1, 2), jk)
    close(v.transpose(1, 2), jv)


@pytest.mark.parametrize("extra", [(), GQA[1]])
def test_gqa_decode_attention_matches(extra):
    """One token per request at its own position against a filled cache:
    the new K/V written there, keys after it masked."""
    cfg, jp, module = _gqa(extra)
    rng = _rng(5)
    s_max, kvh, hd = 16, cfg.num_kv_heads, cfg.head_dim
    x = _normal(rng, (B, 1, cfg.d_model))
    ck, cv = (_normal(rng, (B, s_max, kvh, hd)) for _ in range(2))
    pos = np.array([9, 3], np.int32)
    jout, (jck, jcv) = jattn.gqa_decode_attention(
        jp, cfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos))
    tk, tv = (_t(c).permute(0, 2, 1, 3).contiguous() for c in (ck, cv))
    out, (k2, v2) = module.decode_attention(_t(x), tk, tv, _t(pos))
    close(out, jout)
    assert k2 is tk and v2 is tv                 # updated in place
    close(tk.permute(0, 2, 1, 3), jck)
    close(tv.permute(0, 2, 1, 3), jcv)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_matches(with_state):
    jm, params, model = pair("falcon-mamba-7b")
    cfg = jm.cfg
    jp = jax.tree.map(lambda a: a[1], params["layers"]["mamba"])
    # a_log is zeros at init: give the decay a spread of rates
    rng = _rng(6)
    jp = {**jp, "a_log": _normal(rng, jp["a_log"].shape, 0.5)}
    module = ssm.Mamba(common.Maker("cpu", torch.float32, None), cfg)
    common.load_numpy(module, np_tree(jp))
    x = _normal(rng, (B, 1 if with_state else S, cfg.d_model))
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    state = jstate = None
    if with_state:
        jstate = {"conv": _normal(rng, (B, cfg.ssm_d_conv - 1, di)),
                  "ssm": _normal(rng, (B, di, n), 0.3)}
        state = {k: _t(v) for k, v in jstate.items()}
    jy, jnew = jssm.mamba_block(jp, cfg, jnp.asarray(x), jstate)
    y, new = module(_t(x), state)
    close(y, jy)
    close(new["conv"], jnew["conv"])
    close(new["ssm"], jnew["ssm"])
    assert new["ssm"].dtype == torch.float32


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _inputs(cfg, seed):
    rng = _rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = None
    if cfg.family == "vlm":
        prefix = _normal(rng, (B, cfg.frontend_len, cfg.d_model), 0.02)
    return toks, prefix


def _jkw(prefix):
    return {} if prefix is None else {"prefix_embeds": jnp.asarray(prefix)}


def _close_cache(cfg, cache, jcache):
    if cfg.family == "ssm":
        close(cache["layers"]["conv"], jcache["layers"]["conv"])
        close(cache["layers"]["ssm"], jcache["layers"]["ssm"])
        return
    assert set(cache) == set(jcache)          # "layers" (and "dense")
    for key in cache:
        for c, jc in zip(cache[key], jcache[key]):
            # MLA's latent cache as it is; GQA's [L, B, KVH, S, D]
            # against [L, B, S, KVH, D]
            close(c if cfg.mla else c.permute(0, 1, 3, 2, 4), jc)


@pytest.mark.parametrize("arch,extra", CASES)
def test_prefill_and_decode_match(arch, extra):
    """Prefill logits and caches, then a decode step's logits on the
    expanded cache, and the decode cache after it."""
    jm, params, model = pair(arch, extra)
    cfg = model.cfg
    toks, prefix = _inputs(cfg, 7)
    jlogits, jcache = jm.prefill(params, jnp.asarray(toks), **_jkw(prefix))
    logits, cache = model.prefill(toks, prefix_embeds=prefix)
    assert logits.shape == (B, cfg.vocab_size)
    close(logits, jlogits)
    _close_cache(cfg, cache, jcache)

    max_len = S + 8 + (cfg.frontend_len if prefix is not None else 0)
    jcache = jexpand_cache(jm, jcache, B, max_len)
    cache = expand_cache(model, cache, B, max_len)
    tok = _rng(8).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    pos = np.array([S, S - 3], np.int32)
    jd, jcache2 = jm.decode_step(params, jnp.asarray(tok), jcache,
                                 jnp.asarray(pos))
    d, cache2 = model.decode_step(tok, cache, torch.as_tensor(pos))
    close(d, jd)
    _close_cache(cfg, cache2, jcache2)


@pytest.mark.parametrize("arch", ["gemma-7b", "falcon-mamba-7b",
                                  "internvl2-26b", "qwen2-72b",
                                  "granite-moe-3b-a800m",
                                  "deepseek-v2-236b"])
def test_decode_is_consistent_with_prefill(arch):
    """``tests/test_arch_smoke.py``'s check on the port: prefill(t[:n])
    then decode(t[n]) gives prefill(t[:n+1])'s logits (rtol and atol
    2e-3, the reference's), so flash_decode agrees with flash_attention
    (MLA's absorbed decode with its materialised prefill) and one scan
    step with the scan over the prompt.  The MoE archs hold it because
    reduced() sets capacity_factor 4.0, which drops no token at either
    length (capacity depends on the tokens a row)."""
    model = pair(arch)[2]
    toks = _rng(9).integers(0, model.cfg.vocab_size, (B, 12))
    full, _ = model.prefill(toks)
    _, cache = model.prefill(toks[:, :-1])
    cache = expand_cache(model, cache, B, 12)
    step, _ = model.decode_step(toks[:, -1:], cache,
                                torch.full((B,), 11, dtype=torch.int32))
    torch.testing.assert_close(step, full, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-1.2b", "whisper-base"])
def test_param_count_matches_at_full_size(arch):
    """Counted on the meta device, equal to the JAX package's
    ``eval_shape`` count, at the published widths."""
    model = build_model(get_config(arch), device="meta")
    assert model.param_count() == jbuild_model(
        jget_config(arch)).param_count()
    assert all(p.is_meta for p in model.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_matches(arch):
    """Shapes (head-major per layer) and dtypes of the decode cache."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    spec = build_model(cfg, device="meta").cache_spec(4, 49)
    jspec = jbuild_model(jcfg).cache_spec(4, 49)
    if cfg.family == "ssm":
        for key in ("conv", "ssm"):
            got, want = spec["layers"][key], jspec["layers"][key]
            assert got.is_meta and tuple(got.shape) == want.shape
            assert str(got.dtype).split(".")[1] == str(want.dtype)
    else:
        assert set(spec) == set(jspec)        # "layers" (and "dense")
        for key in spec:
            for got, want in zip(spec[key], jspec[key]):
                shape = tuple(want.shape)
                if not cfg.mla:               # head-major per layer
                    l, b, s, kv, d = shape
                    shape = (l, b, kv, s, d)
                assert got.is_meta and tuple(got.shape) == shape
                assert got.dtype == torch.bfloat16


def test_load_numpy_refuses_a_tree_that_differs():
    _, params, _ = pair("gemma-7b")
    tree = np_tree(params)
    model = build_model(reduced(get_config("gemma-7b")), device="cpu")
    with pytest.raises(KeyError, match="missing"):
        model.load_numpy({k: v for k, v in tree.items() if k != "ln_f"})
    tree["ln_f"] = {"scale": np.ones(3, np.float32)}
    with pytest.raises(ValueError, match="ln_f.scale"):
        model.load_numpy(tree)


def test_load_numpy_takes_bf16_arrays():
    """The published dtype: bf16 arrays (``ml_dtypes``) load bit-exact."""
    jcfg = dataclasses.replace(jreduced(jget_config("falcon-mamba-7b")),
                               dtype="bfloat16")
    params = jbuild_model(jcfg).init(jax.random.PRNGKey(1))
    cfg = dataclasses.replace(reduced(get_config("falcon-mamba-7b")),
                              dtype="bfloat16")
    model = build_model(cfg, device="cpu").load_numpy(np_tree(params))
    w = model.net.layers[1].mamba.w_in
    want = np.asarray(params["layers"]["mamba"]["w_in"][1], np.float32)
    assert w.dtype == torch.bfloat16
    assert np.array_equal(w.float().numpy(), want)


def test_generator_seeds_the_init():
    cfg = reduced(get_config("gemma-7b"))

    def table(seed):
        g = torch.Generator().manual_seed(seed)
        return build_model(cfg, device="cpu", generator=g).net.embed.table
    assert torch.equal(table(3), table(3))
    assert not torch.equal(table(3), table(4))
    lm = build_model(cfg, device="cpu").net
    # the JAX package's scales: table 1.0, fan-in normal, ones and zeros
    assert abs(float(lm.embed.table.std()) - 1.0) < 0.05
    wq = lm.layers[0].attn.wq
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    assert torch.equal(lm.ln_f.scale, torch.ones(cfg.d_model))
