"""Megabytes (1e6 bytes) copied from the host to the device a served
episode: the program's `h2d_bytes` counter (each upload's host bytes:
frames, sine tables) over the episodes of its `serve.predict` spans."""

from portbench.lib import spans


def instrument(run):
    spans.follow(run)


def read(run):
    v = spans.counter_per_episode(run, "h2d_bytes", "serve")
    return None if v is None else v / 1e6
