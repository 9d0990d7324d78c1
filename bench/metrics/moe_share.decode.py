"""Device seconds under models.moe.MoE's forwards over the traced
slice's device busy seconds, in %."""

from bench.readers import range_share

#: what the traced slice has to range
MODULES = {"MoE": ("forward",)}


def read(run):
    return range_share(run, "MoE")
