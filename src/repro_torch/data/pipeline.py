"""Deterministic synthetic LM data (counterpart of
``repro/data/pipeline.py``, numpy as there, so the two packages' batches
are ``np.array_equal``).

Stateless per step: ``batch(step)`` is a pure function of (seed, step,
shape), so a restarted job needs no data-loader state, only the step
from its checkpoint.  The port runs one process: its process index and
count are 0 and 1, and the slice of the global batch it makes is the
whole batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab_size: int = 32000


class SyntheticLM:
    """Zipf-ish token stream with a repeated n-gram, so that the loss
    falls in a short training run."""

    def __init__(self, dcfg: DataConfig, mcfg: ModelConfig,
                 shape: ShapeConfig):
        self.dcfg = dcfg
        self.mcfg = mcfg
        self.shape = shape
        self.process_index = 0
        self.process_count = 1

    def _host_batch(self) -> int:
        b = self.shape.global_batch
        assert b % self.process_count == 0
        return b // self.process_count

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.dcfg.seed * 1_000_003 + step) * 97 + self.process_index)
        b = self._host_batch()
        cfg, shape = self.mcfg, self.shape
        v = min(self.dcfg.vocab_size, cfg.vocab_size)
        text_len = shape.seq_len
        out = {}
        if cfg.family == "vlm":
            text_len = shape.seq_len - cfg.frontend_len
            out["patches"] = rng.standard_normal(
                (b, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.02
        if cfg.family == "encdec":
            out["frames"] = rng.standard_normal(
                (b, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.02
        # zipf-ish marginals + copied spans (learnable structure)
        ranks = np.arange(1, v + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=(b, text_len), p=probs).astype(np.int32)
        span = max(4, text_len // 8)
        toks[:, span:2 * span] = toks[:, :span]          # repeat an ngram
        out["tokens"] = toks
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1
