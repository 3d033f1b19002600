"""Milliseconds a next_action call (a synchronised span around the task's
method), mean a call."""

from portbench.lib.readers import span_per


def instrument(run):
    run.span(run.objects["task"], "next_action", "next_action")


def read(run):
    return span_per(run, "next_action", "calls")
