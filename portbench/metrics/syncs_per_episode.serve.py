"""Synchronisations with the device a served episode: the program's `syncs`
counter (each call that waits for the card: the frame uploads of every
next_action and predict, the sine tables) over the episodes of its
`serve.predict` spans, in the traced run's second half window."""

from portbench.lib import spans


def instrument(run):
    spans.follow(run)


def read(run):
    return spans.counter_per_episode(run, "syncs", "serve")
