"""Milliseconds a served episode that the host spent in the program's
`sync.*` spans, waiting for the device, in the traced run's second half
window (where the benchmark's synchronising spans around next_action and
adapt drain the queue first, so this reads low)."""

from portbench.lib import spans


def instrument(run):
    spans.follow(run)


def read(run):
    return spans.sync_ms(run, "serve")
