"""Served episodes a second over the window's whole chunks, from the first
chunk's start to the last one's end, predictions on the host."""


def read(run):
    w = run.window
    return w["episodes"] / w["seconds"] if w.get("latencies") else None
