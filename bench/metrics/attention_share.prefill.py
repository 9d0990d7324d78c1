"""Device seconds under models.attention.MLA's forwards over the traced
slice's device busy seconds, in %."""

from bench.readers import range_share

#: what the traced slice has to range
MODULES = {"MLA": ("self_attention", "decode_attention")}


def read(run):
    return range_share(run, "MLA")
