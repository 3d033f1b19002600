"""Synchronisations with the device a train episode: the program's `syncs`
counter (each call on the step's path that waits for the card: the batch's
uploads, the sine tables, the criterion's copies to the host and nonzero,
the grad norm's float) over the episodes of its `train.step` spans, in the
traced run's second half window."""

from portbench.lib import spans


def instrument(run):
    spans.follow(run)


def read(run):
    return spans.counter_per_episode(run, "syncs", "train")
