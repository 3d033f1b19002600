"""Milliseconds a step that the step waited for the loader's next batch."""

from portbench.lib.readers import span_per


def read(run):
    return span_per(run, "loader_wait", "steps")
