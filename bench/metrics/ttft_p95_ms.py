"""The 95th percentile over every request of the window of the time
from its submission to its first token, in ms.  ``serve.Engine``
returns a call's tokens when ``generate`` ends, so a request receives
its first token when its call returns."""

from bench.readers import quantile


def read(run):
    if not run.records:
        return None
    return quantile([1e3 * (r["done"] - r["submit"])
                     for r in run.records
                     for _ in range(r["tokens"].shape[0])], 0.95)
