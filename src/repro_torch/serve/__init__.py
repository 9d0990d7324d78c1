"""Batched serving of the model zoo: prefill, then a greedy or
temperature decode loop over a fixed-capacity cache."""

from repro_torch.serve.engine import Engine, ServeConfig, expand_cache  # noqa: F401
