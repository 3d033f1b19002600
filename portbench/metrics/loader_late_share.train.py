"""100 x the loader's late batches over the batches the step drew: a batch
is late when it was not ready as it was asked for (the program's
`loader.late` and `loader.batches` counters)."""

from portbench.lib import spans


def instrument(run):
    spans.follow(run)


def read(run):
    return spans.share(run, "loader.late", "loader.batches")
