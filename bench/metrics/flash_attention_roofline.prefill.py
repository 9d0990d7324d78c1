"""kernels.ops.flash_attention's calls in the traced slice: their bound
seconds over the device seconds they launched, in %."""

from bench.readers import roofline

#: what the traced slice has to range
OPS = ("flash_attention",)


def read(run):
    return roofline(run, "flash_attention")
