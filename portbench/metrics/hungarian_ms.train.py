"""Milliseconds a step in the criterion's matching, summed over its calls:
the cost matrices, their copy to the host and the scipy solve (a
synchronised span around models/criterion.py's hungarian_match)."""

from portbench.lib.readers import span_per


def instrument(run):
    from interactron_tpu_torch.models import criterion

    run.span(criterion, "hungarian_match", "hungarian")


def read(run):
    return span_per(run, "hungarian", "steps")
