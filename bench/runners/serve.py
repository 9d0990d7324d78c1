"""Serving traffic: a closed loop of ``serve.Engine.generate`` calls,
each of ``batch`` requests with prompts of ``prompt`` tokens drawn
uniformly from the vocabulary and ``output`` greedy tokens each.  The
next call is submitted when the last returns (``clients`` 1), so each
request's time to first token is its call's time: the Engine returns
every token when ``generate`` ends.  Every seed gets the same sizes; the
seed draws the weights and the token ids."""

from __future__ import annotations

import time

import numpy as np
import torch

from bench import weights as W


def prompts_of(seed: int, traffic: dict, call: int, vocab: int):
    """The prompts [batch, prompt] of call ``call`` (-1: the warm-up)."""
    rng = np.random.default_rng([int(seed), 1, call + 1])
    return rng.integers(0, vocab, (traffic["batch"], traffic["prompt"]),
                        dtype=np.int64).astype(np.int32)


class Routing:
    """Keeps, for each forward of each of the port's ``MoE`` layers, the
    tensors its ``_dispatch`` returned that say which experts each token
    chose and which choices had room: ``gate_idx`` [B, S, k], and
    ``order`` and ``keep`` [B, S*k] in expert order.  No copy and no
    device work: the wrapper holds on to tensors the layer made anyway
    (on each instance, wrapped while the runner runs).

    It reads a method of the port's own, ``MoE._dispatch``, and positions
    2, 3 and 5 of what it returns: each capture checks their shapes and
    dtypes and stops the run, naming what it found, where they are not
    what this expects."""

    def __init__(self, model, top_k: int):
        self.top_k = top_k
        self.layers = [m for m in model.modules()
                       if type(m).__name__ == "MoE"]
        self.calls: list[list] = [[] for _ in self.layers]
        for i, mod in enumerate(self.layers):
            mod._dispatch = self._wrap(i, mod._dispatch)

    def _wrap(self, i, fn):
        def dispatch(x, probs):
            out = fn(x, probs)
            self.calls[i].append(self.routing_of(x, out))
            return out
        return dispatch

    def routing_of(self, x, out) -> tuple:
        """(gate_idx, order, keep) of ``MoE._dispatch(x, probs)``'s
        result ``out``, checked."""
        b, s, k = x.shape[0], x.shape[1], self.top_k
        if len(out) != 6:
            raise RuntimeError(f"MoE._dispatch returned {len(out)} outputs, "
                               "not the 6 the serving check reads")
        found = []
        for pos, name, shape, kind in ((2, "gate_idx", (b, s, k), "integer"),
                                       (3, "order", (b, s * k), "integer"),
                                       (5, "keep", (b, s * k), "bool")):
            t = out[pos]
            ok = isinstance(t, torch.Tensor) and tuple(t.shape) == shape \
                and (t.dtype == torch.bool) == (kind == "bool") \
                and not t.dtype.is_floating_point
            if not ok:
                found.append(f"output {pos} ({name}) is "
                             f"{getattr(t, 'dtype', type(t))} "
                             f"{tuple(getattr(t, 'shape', ()))}, not "
                             f"{kind} {shape}")
        if found:
            raise RuntimeError("MoE._dispatch no longer returns what the "
                               "serving check reads: " + "; ".join(found))
        return out[2], out[3], out[5]

    def take(self) -> list:
        """Each layer's forwards since the last take, and forget them."""
        out, self.calls = self.calls, [[] for _ in self.layers]
        return out

    def remove(self) -> None:
        for mod in self.layers:
            del mod._dispatch


def request_routing(taken: list, row: int) -> list:
    """One request's routing from a call's taken forwards: for each MoE
    layer, (experts [T, k], room [T, k]) over the tokens the call ran
    through the layers (the prompt, then one a decode step)."""
    import torch

    out = []
    for forwards in taken:
        idx, keep = [], []
        for gate_idx, order, kept in forwards:
            inv = torch.argsort(order[row])
            idx.append(gate_idx[row])
            keep.append(kept[row][inv].view(gate_idx.shape[1:]))
        out.append((torch.cat(idx), torch.cat(keep)))
    return out


class Runner:
    def __init__(self, cfg, doc: dict, traffic: dict, seed: int, device,
                 pool_calls: int | None = None):
        """``pool_calls``: the calls the check samples from (the first
        ones, which every window finishes); only theirs keep routing."""
        self.cfg, self.doc, self.traffic = cfg, doc, traffic
        self.seed, self.device = int(seed), device
        self.pool_calls = pool_calls
        self.records: list[dict] = []

    def setup(self) -> None:
        from repro_torch.serve.engine import Engine, ServeConfig

        t = self.traffic
        self.model, self.weights = W.build(self.cfg, self.seed, self.device)
        self.engine = Engine(self.model, ServeConfig(
            max_len=t["prompt"] + t["output"]), device=self.device)
        # the cell's shapes, once: the prefill and two decode steps (every
        # step has the same shapes: the cache is max_len long), so every
        # kernel is built and every library warm
        self._call(-1, min(t["output"], 3))
        self.records.clear()
        moe = any(type(m).__name__ == "MoE" for m in self.model.modules())
        self.routing = (Routing(self.model, self.doc["num_experts_per_tok"])
                        if moe else None)

    def _call(self, i: int, output: int | None = None) -> dict:
        t = self.traffic
        prompts = prompts_of(self.seed, t, i, self.cfg.vocab_size)
        t0 = time.perf_counter()
        tokens = self.engine.generate(prompts, output or t["output"])
        t1 = time.perf_counter()
        routing = getattr(self, "routing", None)
        taken = None if routing is None else routing.take()
        if self.pool_calls is not None and not 0 <= i < self.pool_calls:
            taken = None
        rec = {"call": i, "submit": t0, "done": t1, "prompts": prompts,
               "tokens": tokens, "stats": dict(self.engine.stats),
               "routing": taken}
        self.records.append(rec)
        return rec

    def window(self, seconds: float) -> float:
        """Calls until ``seconds`` have passed since the first was
        submitted; the window ends when the last returns.  Its seconds."""
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds:
            self._call(i)
            i += 1
        return self.records[-1]["done"] - start

    def traced_slice(self) -> None:
        """The traced slice: ``trace_calls`` more calls, past the
        window's (new prompts)."""
        n = len(self.records)
        for i in range(self.traffic.get("trace_calls", 1)):
            self._call(n + i)

    def notes(self) -> list[str]:
        took = sorted(r["done"] - r["submit"] for r in self.records)
        return [f"calls: {len(took)}, seconds each: median "
                f"{took[len(took) // 2]:.4f} [{took[0]:.4f}..{took[-1]:.4f}]"]

    def counts(self) -> tuple[int, int]:
        """(requests attempted, failed) in the window: a request fails
        when its call returned fewer tokens than asked."""
        b, o = self.traffic["batch"], self.traffic["output"]
        failed = sum(b for r in self.records
                     if r["tokens"].shape != (b, o))
        return b * len(self.records), failed

    def release(self) -> None:
        """Free the program's state; the weights (the benchmark's) and the
        records stay."""
        if self.routing is not None:
            self.routing.remove()
        del self.engine, self.model
        torch.cuda.empty_cache() if torch.cuda.is_available() else None
