"""Device kernel launches of the profiled stretch over its episodes."""

from portbench.lib.readers import launches_per_episode


def read(run):
    return launches_per_episode(run)
