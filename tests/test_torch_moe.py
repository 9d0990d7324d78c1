"""The port's MoE layer and MLA attention (``repro_torch.models.moe``,
``repro_torch.models.attention.MLA``) against the JAX package's on the
CPU.  Parameters are the JAX package's init of the reduced archs,
loaded with ``common.load_numpy``; inputs are numpy draws from a seed;
outputs are held within 2e-4 + 2e-4 * |ref|.  The routing (each token's
experts, the stable sort by expert, the slots and which tokens an
expert's capacity drops) is held equal, element for element, also where
the published capacity factor 1.25 drops tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.configs.registry import get_config as jget_config
from repro_torch.configs.registry import get_config
from repro_torch.models import build_model, common, moe
from test_torch_models import _normal, _rng, _t, close, np_tree, pair

#: (arch, batch, tokens a row, capacity factor): the reduced configs'
#: 4.0 drops nothing; the published 1.25 drops 6 (token, choice) pairs in
#: each of the other two
MOE_CASES = [("granite-moe-3b-a800m", 2, 12, 4.0),
             ("granite-moe-3b-a800m", 2, 128, 1.25),
             ("deepseek-v2-236b", 3, 64, 1.25)]


def _moe_layer(arch):
    """(reduced config, layer 0's JAX ``moe`` params, the port's MoE with
    them loaded)."""
    jm, params, model = pair(arch)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    return jm.cfg, jp, model.net.layers[0].moe


@pytest.mark.parametrize("arch,b,s,cf", MOE_CASES)
def test_moe_matches(arch, b, s, cf):
    """``out`` and ``aux``, and every routing array equal to the JAX
    package's ``_route_row``'s on the same gates."""
    cfg, jp, module = _moe_layer(arch)
    module.capacity_factor = cf
    e, k = cfg.num_experts, cfg.experts_per_token
    x = _normal(_rng(20 + s), (b, s, cfg.d_model))
    jout, jaux = jmoe.moe(jp, jnp.asarray(x), num_experts=e, top_k=k,
                          kind=cfg.mlp_act, capacity_factor=cf)
    out, aux = module(_t(x))
    close(out, jout)
    close(aux, jaux)

    # the routes: each token's experts, then the sort, slots and drops
    jprobs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    jidx = np.asarray(jax.lax.top_k(jprobs, k)[1])
    probs = torch.softmax(_t(x) @ module.router, -1)
    idx = torch.topk(probs, k, -1).indices
    np.testing.assert_array_equal(idx.numpy(), jidx)
    cap = moe.capacity(s, k, e, cf)
    want = jax.vmap(lambda gi: jmoe._route_row(gi, e, cap))(
        jnp.asarray(jidx))
    for got, ref in zip(moe.route(idx, e, cap), want):
        assert torch.equal(got, torch.as_tensor(np.asarray(ref),
                                                dtype=got.dtype))
    keep = moe.route(idx, e, cap)[3]
    assert bool(keep.all()) == (cf == 4.0)     # 1.25 drops tokens here


def test_moe_dispatch_and_combine_are_exact():
    """The layer written out choice by choice where tokens are dropped:
    a kept (token, choice) adds its gate times its expert's FFN of the
    token, a dropped one adds nothing."""
    cfg, jp, module = _moe_layer("granite-moe-3b-a800m")
    module.capacity_factor = 1.25
    b, s = 2, 128
    x = _t(_normal(_rng(30), (b, s, cfg.d_model)))
    out, _ = module(x)
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(x @ module.router, -1)
    gates, idx = torch.topk(probs, k, -1)
    gates = gates / gates.sum(-1, keepdim=True)
    order, token, slot, keep = moe.route(idx, e, moe.capacity(s, k, e, 1.25))
    assert not keep.all()
    want = torch.zeros_like(out)
    for row in range(b):
        for j in range(s * k):
            if keep[row, j]:
                t, c = int(token[row, j]), int(order[row, j]) % k
                ex = int(idx[row, t, c])
                w_g, w_u, w_d = (module.w_gate[ex], module.w_up[ex],
                                 module.w_down[ex])
                h = torch.nn.functional.silu(x[row, t] @ w_g) * (
                    x[row, t] @ w_u)
                want[row, t] += gates[row, t, c] * (h @ w_d)
    torch.testing.assert_close(out, want, rtol=2e-4, atol=2e-4)


def _mla():
    jm, params, model = pair("deepseek-v2-236b")
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    return jm.cfg, jp, model.net.layers[0].attn


def test_mla_prefill_attention_matches():
    """Causal prefill through ``ops.flash_attention`` with 24-wide q/k
    heads and 16-wide values (reduced), and the latent cache pieces."""
    cfg, jp, module = _mla()
    b, s = 2, 12
    x = _normal(_rng(40), (b, s, cfg.d_model))
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    jout, (jc, jr) = jattn.mla_self_attention(jp, cfg, jnp.asarray(x),
                                              jnp.asarray(pos))
    out, (c, r) = module.self_attention(_t(x), _t(pos))
    close(out, jout)
    close(c, jc)
    close(r, jr)


def test_mla_decode_attention_matches():
    """The absorbed decode: one ``ops.flash_decode`` with a request's
    heads as its query rows, each request at its own position against a
    filled latent cache, written in place."""
    cfg, jp, module = _mla()
    b, s_max = 3, 16
    rng = _rng(41)
    x = _normal(rng, (b, 1, cfg.d_model))
    cc = _normal(rng, (b, s_max, cfg.kv_lora_rank))
    cr = _normal(rng, (b, s_max, cfg.qk_rope_head_dim))
    pos = np.array([9, 3, 15], np.int32)
    jout, (jcc, jcr) = jattn.mla_decode_attention(
        jp, cfg, jnp.asarray(x), jnp.asarray(cc), jnp.asarray(cr),
        jnp.asarray(pos))
    tc, tr = _t(cc.copy()), _t(cr.copy())
    out, (c2, r2) = module.decode_attention(_t(x), tc, tr, _t(pos))
    assert c2 is tc and r2 is tr                 # updated in place
    close(out, jout)
    close(tc, jcc)
    close(tr, jcr)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b",
                                  "gemma-7b"])
def test_active_param_count_matches_at_full_size(arch):
    """Counted on the meta device, equal to the JAX package's; a dense
    arch uses all its parameters."""
    model = build_model(get_config(arch), device="meta")
    want = jbuild_model(jget_config(arch)).active_param_count()
    assert model.active_param_count() == want
    assert (want < model.param_count()) == (arch != "gemma-7b")


def test_load_numpy_numbers_the_dense_layers():
    """``dense_layers`` (a list in the pytree) maps onto the ModuleList by
    index, and a missing one is refused."""
    _, params, model = pair("deepseek-v2-236b")
    tree = np_tree(params)
    want = tree["dense_layers"][0]["mlp"]["w_up"]
    np.testing.assert_array_equal(
        model.net.dense_layers[0].mlp.w_up.numpy(), want)
    with pytest.raises(KeyError, match="dense_layers.0"):
        common.load_numpy(model.net, {**tree, "dense_layers": []})
