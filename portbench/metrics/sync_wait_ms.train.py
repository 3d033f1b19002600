"""Milliseconds a train step that the host spent in the program's `sync.*`
spans, waiting for the device, in the traced run's second half window.
There the benchmark's own synchronising spans (optimizer_ms.train,
hungarian_ms.train) drain the queue first, so this reads low."""

from portbench.lib import spans


def instrument(run):
    spans.follow(run)


def read(run):
    return spans.sync_ms(run, "train")
