"""Milliseconds a call of the task's adapt inside predict (the inner
step: the frozen prefix, the detector and fusion, the first-order
gradient and the clipped SGD step), mean a call."""

from portbench.lib.readers import span_per


def instrument(run):
    run.span(run.objects["task"], "adapt", "adapt")


def read(run):
    return span_per(run, "adapt", "calls")
