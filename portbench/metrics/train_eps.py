"""Episodes a second over the window's whole meta-train steps, from the
first step's start to the last one's end (synchronised)."""


def read(run):
    w = run.window
    return w["episodes"] / w["seconds"] if w.get("steps") else None
