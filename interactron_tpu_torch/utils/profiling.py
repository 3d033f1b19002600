"""Timing and tracing (counterpart of interactron_tpu/utils/profiling.py):
section timing that waits for the card, and torch.profiler traces.

CUDA calls return before the card finishes, so a host clock read without a
synchronize measures the enqueueing; every reading here synchronizes the
current CUDA device first, where one is in use."""

import contextlib
import os
import time

import torch


def synchronize():
    """Wait for the current CUDA device's queued work, where CUDA is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Section timer: `tick(msg)` closes the section since the last tick
    (or construction) after the card has finished it."""

    def __init__(self):
        synchronize()
        self.t0 = time.perf_counter()
        self.laps = []

    def tick(self, msg):
        synchronize()
        now = time.perf_counter()
        self.laps.append((msg, now - self.t0))
        self.t0 = now
        return self.laps[-1][1]

    def report(self):
        return "\n".join(f"{m}: {dt * 1000:.2f} ms" for m, dt in self.laps)


@contextlib.contextmanager
def trace(log_dir):
    """torch.profiler over the block (the CPU, and CUDA where it is in use),
    its Chrome trace written to `log_dir`/trace.json on exit; yields the
    profiler, whose `key_averages()` sums the time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed(fn, *args, iters=5, warmup=1, **kwargs):
    """`fn(*args, **kwargs)` `warmup` times, then `iters` times between two
    synchronizes: (the last result, seconds a call)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    synchronize()
    return out, (time.perf_counter() - t0) / iters
