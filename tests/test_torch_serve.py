"""The port's serving engine and launcher (``repro_torch.serve``,
``repro_torch.launch.serve``) against the JAX package's on the CPU:
greedy tokens equal to the reference ``Engine``'s on the same params and
prompts, the vlm decode-position quirk kept, seeded sampling, and the
CLI run end to end."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.serve import Engine, ServeConfig, expand_cache
from test_torch_models import ARCHS, GEMMA_MOE, GQA, ZAMBA2_TAIL, pair

B, P, STEPS = 3, 10, 8


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    prefix = None
    if cfg.family == "vlm":
        prefix = (rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
                  * 0.02).astype(np.float32)
    return prompts, prefix


@pytest.mark.parametrize("arch,extra",
                         [(a, ()) for a in ARCHS] + [GQA, GEMMA_MOE]
                         + [("zamba2-1.2b", ()), ZAMBA2_TAIL])
def test_greedy_tokens_equal_the_reference_engine(arch, extra):
    jm, params, model = pair(arch, extra)
    prompts, prefix = _prompts(model.cfg)
    max_len = P + STEPS + 1 + (0 if prefix is None else
                               model.cfg.frontend_len)
    kw = {} if prefix is None else {"prefix_embeds": jnp.asarray(prefix)}
    want = JEngine(jm, params, JServeConfig(max_len=max_len)).generate(
        prompts, STEPS, **kw)
    engine = Engine(model, ServeConfig(max_len=max_len), device="cpu")
    got = engine.generate(prompts, STEPS, prefix_embeds=prefix)
    assert got.dtype == np.int32 and got.shape == (B, STEPS)
    np.testing.assert_array_equal(got, want)
    assert engine.stats["decode_steps"] == STEPS - 1


def test_vlm_first_decode_position_is_the_prompt_length():
    """Kept from the JAX package: with a prefix, decoding starts at the
    prompt's length (it writes over a prefix slot and attends to the
    first P + 1 keys), not at prefix + prompt."""
    model = pair("internvl2-26b")[2]
    prompts, prefix = _prompts(model.cfg, seed=1)
    max_len = model.cfg.frontend_len + P + STEPS
    engine = Engine(model, ServeConfig(max_len=max_len), device="cpu")
    got = engine.generate(prompts, 2, prefix_embeds=prefix)
    logits, cache = model.prefill(prompts, prefix_embeds=prefix)
    cache = expand_cache(model, cache, B, max_len)
    tok = logits.argmax(-1)
    step, _ = model.decode_step(tok[:, None], cache,
                                torch.full((B,), P, dtype=torch.int32))
    np.testing.assert_array_equal(got[:, 1], step.argmax(-1).numpy())


def test_temperature_sampling_is_seeded():
    model = pair("gemma-7b")[2]
    prompts, _ = _prompts(model.cfg)

    def sample(seed):
        scfg = ServeConfig(max_len=P + STEPS, temperature=1.0, seed=seed)
        return Engine(model, scfg, device="cpu").generate(prompts, STEPS)
    a = sample(5)
    np.testing.assert_array_equal(a, sample(5))
    assert not np.array_equal(a, sample(6))
    assert ((a >= 0) & (a < model.cfg.vocab_size)).all()


def test_expand_cache_pads_to_the_spec_and_refuses_overflow():
    model = pair("gemma-7b")[2]
    _, cache = model.prefill(np.zeros((B, P), np.int32))
    out = expand_cache(model, cache, B, P + 5)
    for c, s in zip(out["layers"], model.cache_spec(B, P + 5)["layers"]):
        assert c.shape == s.shape and c.dtype == s.dtype
    assert torch.equal(out["layers"][0][..., :P, :], cache["layers"][0])
    assert not out["layers"][0][..., P:, :].any()
    with pytest.raises(ValueError, match="does not fit"):
        expand_cache(model, cache, B, P - 1)


def test_engine_refuses_a_model_on_another_device():
    model = build_model(reduced(get_config("gemma-7b")), device="meta")
    with pytest.raises(ValueError, match="the model is on meta"):
        Engine(model, ServeConfig(), device="cpu")


@pytest.mark.parametrize("arch", ["gemma-7b", "internvl2-26b",
                                  "falcon-mamba-7b", "granite-moe-3b-a800m",
                                  "deepseek-v2-236b", "zamba2-1.2b",
                                  "whisper-base"])
def test_launch_serve_runs_on_the_cpu(arch, capsys):
    """The CLI sizes the cache to prompt + steps + 1, as the JAX
    package's does, so a vlm's prefix (8 reduced) must fit in steps + 1;
    an encdec model's frames are drawn after the prompts."""
    tokens = launch_serve.main(["--arch", arch, "--reduced", "--device",
                                "cpu", "--batch", "2", "--prompt-len", "8",
                                "--steps", "8"])
    out = capsys.readouterr().out.splitlines()
    assert re.match(r"generated \(2, 8\) in [\d.]+s \([\d.]+ tok/s\)", out[0])
    assert tokens.shape == (2, 8) and (tokens < 1024).all()
