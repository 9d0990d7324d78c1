"""The traced slice's seconds with no device operation running, in %
of its length."""

from bench.readers import idle_share


def read(run):
    return idle_share(run)
