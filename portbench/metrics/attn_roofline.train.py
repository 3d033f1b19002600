"""The attention kernels' least time at each launch's shapes over their
device time in the profiled stretch, in %."""

from portbench.lib.readers import attn_roofline


def read(run):
    return attn_roofline(run)
