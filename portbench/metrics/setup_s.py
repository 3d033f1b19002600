"""Set-up seconds: import, kernels loaded (built on a first run), weights
made and calibrated on the card, inputs written, every shape warmed up."""


def read(run):
    return run.setup_s
