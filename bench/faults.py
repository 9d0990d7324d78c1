"""Faults the check has to catch, planted in the port for the length of
a ``with planted(name)`` block (its attributes replaced, then restored):
the calibration reads them on the card, the tests see ``correct`` come
out false under them.  None of them is ever planted in a benchmark run.

* ``state_unchanged``: a step returns its state unchanged: the decode
  step writes nothing into the cache.
* ``half_batch``: half of the batch left out: the decode step runs the
  first half of the rows and hands their logits to the other half.
* ``token_altered``: a served token altered where it is produced: the
  first token of every request (the one a prefill serves) is the next id
  after the best.
"""

from __future__ import annotations

import contextlib


def _state_unchanged():
    from repro_torch.models import attention

    def no_write(cache, new, pos, dim):
        return None
    return [(attention, "write_at", no_write)]


def _half_batch():
    from repro_torch.models.api import Model

    decode = Model.decode_step

    def half_decode(self, tokens, cache, position_idx):
        logits, cache = decode(self, tokens, cache, position_idx)
        h = (logits.shape[0] + 1) // 2
        logits[h:] = logits[:logits.shape[0] - h]
        return logits, cache
    return [(Model, "decode_step", half_decode)]


def _token_altered():
    from repro_torch.serve.engine import Engine

    generate, sample = Engine.generate, Engine._sample

    def counted_generate(self, *args, **kwargs):
        self._fault_calls = 0
        return generate(self, *args, **kwargs)

    def altered(self, logits, gen):
        tok = sample(self, logits, gen)
        self._fault_calls = getattr(self, "_fault_calls", 0) + 1
        if self._fault_calls == 1:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    return [(Engine, "generate", counted_generate),
            (Engine, "_sample", altered)]


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


@contextlib.contextmanager
def planted(name: str | None):
    """The fault ``name`` planted while the block runs (None: none)."""
    if name is None:
        yield
        return
    patches = FAULTS[name]()
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, new in patches:
        setattr(obj, attr, new)
    try:
        yield
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)
