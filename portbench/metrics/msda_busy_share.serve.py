"""The deformable attention kernels' share of the profiled stretch's busy
device time, in %, where the program recorded their launches
(lib/msda.py)."""

from portbench.lib import msda, spans


def instrument(run):
    spans.follow(run)


def read(run):
    return msda.busy_share(run)
