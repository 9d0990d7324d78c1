"""DeepSeek-V2 as the port computes it (the configuration file's
``departures``), in plain PyTorch and fp32, teacher-forced: the logits of
each request's served tokens given its prompt and the tokens served
before them.

The weights are the benchmark's, by the names it drew them under.  Every
layer runs over all tokens of all requests in blocks of rows (attention
request by request, a block of heads at a time), so that it fits beside
the served weights on the card.  Routing follows the port: the top 6 of
the softmax over 160 router logits (fp32), the gates renormalised, each
expert taking at most ``capacity`` choices of a forward call's batch row
(the prompt is one call; each generated token is a call of one token, at
which no choice is dropped), later tokens dropped first.

Given ``routing`` (the experts each token chose and which choices had
room, in every MoE layer), the reference takes those choices in place
of its own top 6 and its own drops -- the gates still its own softmax's
-- and reads how far they stand from its own: the widest margin by which
a chosen expert's router logit lies below its own sixth best
(``regret``), and how many of the given drops differ from what the
capacity rule makes of the given choices (``mismatched_drops``).  A
random 8-layer MoE in bf16 chooses otherwise than one in fp32 wherever
two experts nearly tie, and a changed choice or drop changes the token
and, through attention, every later one: followed, the two stay within
rounding of each other.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.numerics import Numerics

#: rows a token-wise block takes; scores an attention block holds
ROWS = 4096
SCORES = 1 << 27


def capacity(seq: int, top_k: int, experts: int, factor: float) -> int:
    """Slots an expert has in a forward call's batch row of ``seq``
    tokens (the configuration's departures)."""
    cap = int(math.ceil(seq * top_k / experts * factor))
    return max(cap, min(seq * top_k, 8), 1)


def rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x, pos, theta):
    """x [T, heads, dim] rotated by halves at positions ``pos`` [T]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, scale):
    """q, k [T, h, d], v [T, h, dv]: causal softmax attention in fp32, a
    block of heads and query rows at a time (``SCORES`` scores a block)."""
    t, h = q.shape[:2]
    rows = max(1, min(t, SCORES // (t * h)))
    heads = max(1, min(h, SCORES // (t * rows)))
    out = torch.empty(t, h, v.shape[-1], device=q.device)
    for r0 in range(0, t, rows):
        end = min(t, r0 + rows)
        pos = torch.arange(r0, end, device=q.device)
        # keys past the block's last row are masked for every row of it
        mask = pos[:, None] >= torch.arange(end, device=q.device)[None, :]
        for h0 in range(0, h, heads):
            hs = slice(h0, h0 + heads)
            s = torch.einsum("thd,shd->hts", q[r0:end, hs], k[:end, hs])
            s.mul_(scale).masked_fill_(~mask, float("-inf"))
            out[r0:end, hs] = torch.einsum("hts,shd->thd",
                                           torch.softmax(s, -1), v[:end, hs])
    return out


class DeepSeekV2:
    def __init__(self, weights: dict, doc: dict, numerics: Numerics):
        self.w, self.doc, self.num = weights, doc, numerics
        self.eps = doc["rms_norm_eps"]
        self.factor = doc.get("capacity_factor", 1.25)
        self.routing: list = []
        self.regret, self.mismatched_drops = 0.0, 0

    def mla(self, p, x, pos):
        """One request's attention: x [T, d] at positions ``pos``."""
        w, d, num = self.w, self.doc, self.num
        h = d["num_attention_heads"]
        dn, dr, dv = (d["qk_nope_head_dim"], d["qk_rope_head_dim"],
                      d["v_head_dim"])
        kvr = d["kv_lora_rank"]
        t = x.shape[0]
        qa = rms(num.mm(x, w[p + "wq_a"]), w[p + "q_norm.scale"], self.eps)
        q = num.mm(qa, w[p + "wq_b"].reshape(qa.shape[1], -1)
                   ).view(t, h, dn + dr)
        q = torch.cat([q[..., :dn], rope(q[..., dn:], pos,
                                         d["rope_theta"])], -1)
        kv = num.mm(x, w[p + "wkv_a"])
        c = rms(kv[:, :kvr], w[p + "kv_norm.scale"], self.eps)
        k_rope = rope(kv[:, None, kvr:], pos, d["rope_theta"])
        k = torch.cat([num.mm(c, w[p + "wk_b"].reshape(kvr, -1)
                              ).view(t, h, dn),
                       k_rope.expand(t, h, dr)], -1)
        v = num.mm(c, w[p + "wv_b"].reshape(kvr, -1)).view(t, h, dv)
        ctx = causal_attention(q, k, v, (dn + dr) ** -0.5)
        return num.mm(ctx.reshape(t, h * dv), w[p + "wo"].reshape(h * dv, -1))

    def swiglu(self, x, wg, wu, wd):
        num = self.num
        return num.mm(F.silu(num.mm(x, wg)) * num.mm(x, wu), wd)

    def keep(self, idx, segments):
        """Which (token, choice) pairs an expert has room for: ``idx``
        [N, k] the choices of all tokens, ``segments`` the lengths of the
        forward calls' rows they fall in, in order."""
        e, k = self.doc["n_routed_experts"], idx.shape[1]
        out, start = [], 0
        for seg in segments:
            flat = idx[start:start + seg].reshape(-1)
            onehot = F.one_hot(flat, e)
            rank = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
            out.append((rank < capacity(seg, k, e, self.factor)).view(seg, k))
            start += seg
        return torch.cat(out)

    def moe(self, p, x, segments, given=None):
        """x [N, d], every token of every request; ``segments`` as
        :meth:`keep`'s; ``given`` the layer's (experts, room) to follow."""
        w, d = self.w, self.doc
        k = d["num_experts_per_tok"]
        logits = x @ w[p + "router"].float()
        probs = torch.softmax(logits, -1)
        if given is None:
            idx = torch.topk(probs, k, -1).indices
            keep = self.keep(idx, segments)
        else:
            idx, keep = given
            kth = torch.topk(logits, k, -1).values[:, -1:]
            self.regret = max(self.regret, float(
                (kth - logits.gather(-1, idx)).clamp_min(0).max()))
            self.mismatched_drops += int(
                (self.keep(idx, segments) != keep).sum())
        self.routing.append((idx, keep))
        vals = torch.gather(probs, -1, idx)
        gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
        out = torch.zeros_like(x)
        for e in range(d["n_routed_experts"]):
            tok, j = torch.nonzero((idx == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self.swiglu(x[tok], w[p + "w_gate"][e], w[p + "w_up"][e],
                            w[p + "w_down"][e])
            out.index_add_(0, tok, y * gates[tok, j][:, None])
        sh = p + "shared."
        return out + self.rowwise(lambda r: self.swiglu(
            r, w[sh + "w_gate"], w[sh + "w_up"], w[sh + "w_down"]), x)

    @staticmethod
    def rowwise(fn, x):
        return torch.cat([fn(x[i:i + ROWS]) for i in range(0, len(x), ROWS)])

    def layer(self, p, x, n, t, segments, dense: bool, given=None):
        w = self.w
        pos = torch.arange(t, device=x.device)
        h = rms(x, w[p + "ln_attn.scale"], self.eps)
        x = x + torch.cat([self.mla(p + "attn.", h[i * t:(i + 1) * t], pos)
                           for i in range(n)])
        h = rms(x, w[p + "ln_mlp.scale"], self.eps)
        if dense:
            m = p + "mlp."
            f = self.rowwise(lambda r: self.swiglu(
                r, w[m + "w_gate"], w[m + "w_up"], w[m + "w_down"]), h)
        else:
            f = self.moe(p + "moe.", h, segments, given)
        return x + f


@torch.no_grad()
def served_logits(weights: dict, doc: dict, prompts: torch.Tensor,
                  served: torch.Tensor, numerics: Numerics | None = None,
                  routing: list | None = None):
    """prompts [n, P] and the tokens served after them [n, O] (greedy)
    -> (the fp32 logits [n, O, V] each served token was chosen from: at
    the prompt's last position and at each served token but the last;
    a record).  ``routing``: for each MoE layer, (experts [n*T, k], room
    [n*T, k]) over the n requests' T = P + O - 1 tokens in order, to
    follow.  The record holds the routing taken (the same form) and,
    when following, ``regret`` and ``mismatched_drops``."""
    ref = DeepSeekV2(weights, doc, numerics or Numerics())
    n, plen = prompts.shape
    o = served.shape[1]
    tokens = torch.cat([prompts, served[:, :-1]], 1)          # [n, T]
    t = tokens.shape[1]
    x = weights["embed.table"][tokens.reshape(-1)].float()     # [n*T, d]
    # a request's rows: its prompt (one call), then one call a token
    segments = ([plen] + [1] * (o - 1)) * n
    first = doc["first_k_dense_replace"]
    for i in range(doc["num_hidden_layers"]):
        dense = i < first
        prefix = f"dense_layers.{i}." if dense else f"layers.{i - first}."
        given = None if dense or routing is None else routing[i - first]
        x = ref.layer(prefix, x, n, t, segments, dense, given)
    x = x.view(n, t, -1)[:, plen - 1:]                          # [n, O, d]
    x = rms(x, weights["ln_f.scale"], ref.eps)
    logits = ref.num.mm(x.reshape(n * o, -1), weights["head.w"])
    return logits.view(n, o, -1), {"routing": ref.routing,
                                   "regret": ref.regret,
                                   "mismatched_drops": ref.mismatched_drops}
