"""The fast weights' conv work (every trainable k>1 conv, each forward,
input and kernel gradient the path takes) of the profiled stretch over the
device time of their kernels, in % of the bf16 peak."""

from portbench.lib.readers import fwconv_roofline


def read(run):
    return fwconv_roofline(run, "serve")
