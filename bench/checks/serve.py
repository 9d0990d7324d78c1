"""A served model's tokens against the reference: a sample of the
window's requests, drawn from the seed, run once through the reference
teacher-forced (prompt and served tokens).  Greedy tokens only, so a
sound program's gaps are rounding's: its token is its own best, whose
reference logit lies within the two sides' difference of the
reference's best.

Where the model routes tokens to experts, the reference follows the
program's own choices and drops (kept by ``bench.runners.serve.Routing``)
and checks that stage by itself: in bf16 a random 8-layer MoE chooses
otherwise than in fp32 wherever two experts nearly tie, and one changed
choice changes every later token (``bench.reference.deepseek_v2``).

* ``served_gap``: the widest gap by which a served token's reference
  logit lies below the reference's best at its position.
* ``routing_regret``: the widest margin by which an expert the program
  chose lies below the reference's sixth best router logit (at the
  reference's state, which follows the program's choices).
* ``mismatched_drops``: the program's drops that differ from what the
  capacity rule makes of its own choices (exact: 0).

The reference runs the sample in passes of whole requests, each of at
most ``PASS_TOKENS`` tokens, so that it fits beside the served weights;
a cell's ``reference`` of ``"tf32"`` runs its fp32 products as TF32
(``bench.reference.numerics``).
"""

from __future__ import annotations

import numpy as np
import torch

from bench.runners.serve import request_routing
from bench.reference import for_config
from bench.reference.numerics import Numerics, products

#: tokens a pass of the reference runs at most (requests whole)
PASS_TOKENS = 1 << 15


def sample(records: list, seed: int, n: int, pool: int | None = None) -> list:
    """``n`` (call, row) requests of the window's first ``pool`` calls
    (all where None), drawn from the seed (every request is as long as
    the longest)."""
    pairs = [(i, r) for i, rec in enumerate(records[:pool])
             for r in range(rec["tokens"].shape[0])]
    rng = np.random.default_rng([int(seed), 3])
    pick = rng.choice(len(pairs), size=min(n, len(pairs)), replace=False)
    return [pairs[j] for j in sorted(pick)]


def inputs(records: list, picks: list, device):
    """(prompts [n, P], served [n, O], routing or None) of the picked
    requests; the routing in ``served_logits``' form."""
    prompts = np.stack([records[i]["prompts"][r] for i, r in picks])
    served = np.stack([records[i]["tokens"][r] for i, r in picks])
    routing = None
    if records[picks[0][0]]["routing"] is not None:
        each = [request_routing(records[i]["routing"], r) for i, r in picks]
        routing = [tuple(torch.cat([req[layer][j] for req in each])
                         for j in (0, 1)) for layer in range(len(each[0]))]
    return (torch.as_tensor(prompts, dtype=torch.long, device=device),
            torch.as_tensor(served, dtype=torch.long, device=device),
            routing)


def gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Reference logits [n, O, V]: each token's gap below the best."""
    return logits.max(-1).values - logits.gather(-1, tokens[..., None])[..., 0]


def reference_logits(weights, doc, prompts, served, precision="fp32",
                     routing=None, tf32=False):
    """The reference's (logits, record) (``served_logits``); the card's
    fp32 products as TF32 where ``tf32``."""
    ref = for_config(doc)
    with products(tf32):
        return ref.served_logits(weights, doc, prompts, served,
                                 Numerics(precision), routing)


def numbers(logits, record, served, routed: bool) -> dict:
    out = {"served_gap": float(gaps(logits, served).max())}
    if routed:
        out["routing_regret"] = float(record["regret"])
        out["mismatched_drops"] = float(record["mismatched_drops"])
    return out


def merged(a: dict, b: dict) -> dict:
    """Two passes' numbers as one: the widest gap, the drops summed."""
    return {k: a[k] + b[k] if k == "mismatched_drops" else max(a[k], b[k])
            for k in b} if a else b


def passes(runner, limits: dict, seed: int):
    """The sampled requests in passes of the reference, each of at most
    ``PASS_TOKENS`` tokens (one request where it is longer): (prompts,
    served, routing) of each, on the weights' device."""
    picks = sample(runner.records, seed, limits["sample"],
                   limits.get("pool_calls"))
    rec = runner.records[picks[0][0]]
    each = rec["prompts"].shape[1] + rec["tokens"].shape[1] - 1
    n = max(1, PASS_TOKENS // each)
    device = next(iter(runner.weights.values())).device
    for i in range(0, len(picks), n):
        yield inputs(runner.records, picks[i:i + n], device)


def compare(runner, doc: dict, limits: dict, seed: int) -> list:
    tf32 = limits.get("reference") == "tf32"
    got: dict = {}
    for prompts, served, routing in passes(runner, limits, seed):
        logits, record = reference_logits(runner.weights, doc, prompts,
                                          served, routing=routing, tf32=tf32)
        got = merged(got, numbers(logits, record, served,
                                  routing is not None))
        del logits, record
    return [{"name": k, "value": v, "limit": limits[k]}
            for k, v in got.items()]


def control(runner, doc: dict, limits: dict, seed: int) -> dict:
    """The control's numbers: the reference in fp8 in the program's place
    on the same requests (its own choices, drops and tokens), judged as
    the program's are."""
    tf32 = limits.get("reference") == "tf32"
    got: dict = {}
    for prompts, served, routing in passes(runner, limits, seed):
        low, low_record = reference_logits(runner.weights, doc, prompts,
                                           served, "fp8", tf32=tf32)
        own = low_record["routing"] if routing is not None else None
        logits, record = reference_logits(runner.weights, doc, prompts,
                                          served, routing=own, tf32=tf32)
        got = merged(got, numbers(logits, record, low.argmax(-1),
                                  routing is not None))
        del low, low_record, logits, record
    return got
