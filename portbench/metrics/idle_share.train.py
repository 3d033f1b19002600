"""100 x (1 - device busy / wall) over the profiled stretch (one stream)."""

from portbench.lib.readers import idle_share


def read(run):
    return idle_share(run)
