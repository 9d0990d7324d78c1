"""The published model's operations for the requests served in the
window over the window's seconds, in % of the bf16 peak (989 TFLOP/s)."""

from bench.readers import serve_mfu


def read(run):
    return serve_mfu(run)
