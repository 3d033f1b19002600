"""Milliseconds a step in the trainer's apply_grads: the joint clip and the
two Adam steps (a synchronised span around the instance's method)."""

from portbench.lib.readers import span_per


def instrument(run):
    run.span(run.objects["trainer"], "apply_grads", "apply_grads")


def read(run):
    return span_per(run, "apply_grads", "steps")
