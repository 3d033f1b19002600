"""The whole step's share of the bf16 peak over the traced run's first half
window, which runs with the spans and the profiler off: the reference's
FLOPs an episode times the episodes, over the seconds and 989 TFLOP/s."""

from portbench.lib.readers import mfu


def read(run):
    return mfu(run, "train")
