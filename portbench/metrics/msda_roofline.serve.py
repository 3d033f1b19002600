"""The deformable attention kernels' least time at the program's recorded
launch shapes over their device time in the profiled stretch, in %
(lib/msda.py)."""

from portbench.lib import msda, spans


def instrument(run):
    spans.follow(run)


def read(run):
    return msda.roofline_share(run)
