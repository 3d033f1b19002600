"""One profiled stretch of the window, reduced to what the per-layer
readers need (the attribution is copied from the port's chip_smoke.py).

Under `torch.profiler` (CPU and CUDA activities) the stretch records:
  * every device kernel: name, start and duration; busy time is their sum
    (the paths launch on one stream) and the idle share 1 - busy / wall;
  * the fast weights' convolutions: a "fast_weight_conv" range around each
    trainable k>1 `Conv2d` forward, and every backward node those ops
    created at any order of differentiation (autograd sequence numbers),
    with the device kernels under them, whatever the conv's formulation;
  * every launch of the port's attention kernels with its shapes, taken at
    the point where the port counts its launches (`_launch`);
  * the longest idle gaps on the device, named by the innermost host op
    that was running when each began.
"""

import bisect
import contextlib
import ctypes
import time
from dataclasses import dataclass, field

import torch

from portbench.lib import roofline


@dataclass
class Stretch:
    wall_s: float = 0.0
    busy_s: float = 0.0
    kernels: int = 0
    by_name: dict = field(default_factory=dict)  # device kernel name -> [count, seconds]
    conv_s: float = 0.0
    conv_kernels: int = 0
    launches: list = field(default_factory=list)  # (name, b, t, s, h, d, elt, rate)
    gaps: list = field(default_factory=list)  # [host op, seconds], longest first
    episodes: int = 0


def _subtree(e):
    yield e
    for c in e.cpu_children:
        yield from _subtree(c)


def fast_weight_conv_events(events):
    """The events of the fast weights' convolutions: every op inside a
    "fast_weight_conv" range, and every backward node those ops created, at
    any order of differentiation: an autograd node's evaluation carries the
    (thread, sequence number) of the op that made it, and the ops inside it
    make the nodes of the next order. One chronological pass finds them."""
    made, picked = set(), {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        root = e.name == "fast_weight_conv" or (
            "evaluate_function" in e.name and (e.fwd_thread, e.sequence_nr) in made)
        if root and e.id not in picked:
            for s in _subtree(e):
                picked[s.id] = s
                if s.sequence_nr >= 0:
                    made.add((s.thread, s.sequence_nr))
    return list(picked.values())


@contextlib.contextmanager
def _conv_ranges():
    from torch.profiler import record_function

    from interactron_tpu_torch.models.layers import Conv2d

    forward = Conv2d.forward

    def ranged(self, x):
        if self.frozen or self.kernel_size == 1:
            return forward(self, x)
        with record_function("fast_weight_conv"):
            return forward(self, x)

    Conv2d.forward = ranged
    try:
        yield
    finally:
        Conv2d.forward = forward


@contextlib.contextmanager
def _launch_records(out):
    """Record (name, B, T, S, H, D, element bytes, rate) of every attention
    kernel launch; the ints follow the pointers in each kernel's argtypes."""
    from interactron_tpu_torch.ops import flash_attention as fa

    launch = fa._launch

    def recorded(name, *args):
        if name in roofline.KERNELS:
            i = fa._ARGTYPES[name].index(ctypes.c_int)
            b, t, s, h, d, dt = args[i:i + 6]
            scale, on = args[i + 8], args[i + 9]
            out.append((name, b, t, s, h, d, 4 if dt == 0 else 2,
                        (1.0 - 1.0 / scale) if on else 0.0))
        return launch(name, *args)

    fa._launch = recorded
    try:
        yield
    finally:
        fa._launch = launch


def _idle_gaps(kernels, host_ops, top=10):
    """The `top` longest gaps between consecutive kernels, each named by the
    innermost host op running at its start ("(between host ops)" where the
    profiler records none: Python between two ops)."""
    spans = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, reverse=True)[:top]
    ops = sorted(((o.time_range.start, o.time_range.end, o.name) for o in host_ops))
    starts = [o[0] for o in ops]
    out = []
    for length, at in gaps:
        name, best = "(between host ops)", None
        for s, e, n in ops[:bisect.bisect_right(starts, at)]:
            if e >= at and (best is None or s >= best):
                name, best = n, s
        out.append([name, length / 1e6])
    return out


def profile(run, fn, episodes):
    """Run `fn` (whole steps or chunks of `run`'s traffic, `episodes`
    episodes) under the profiler; returns a Stretch."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    st = Stretch(episodes=episodes)
    activities = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    run.sync()
    with _conv_ranges(), _launch_records(st.launches), torch_profile(
            activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        run.sync()
        st.wall_s = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    for k in kernels:
        entry = st.by_name.setdefault(k.name, [0, 0.0])
        entry[0] += 1
        entry[1] += k.time_range.elapsed_us() / 1e6
    st.kernels = len(kernels)
    st.busy_s = sum(v[1] for v in st.by_name.values())
    conv = [k for e in fast_weight_conv_events(events) for k in (e.kernels or [])
            if k.name != "fast_weight_conv"]
    st.conv_s = sum(k.duration for k in conv) / 1e6
    st.conv_kernels = len(conv)
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    st.gaps = _idle_gaps(kernels, host)
    return st


def breakdown(st, top=10):
    """The trace's summary for the result line: the device operations that
    took most time and the longest idle gaps by host op, in seconds."""
    ops = sorted(st.by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[n[:160], v[1]] for n, v in ops],
            "idle_gaps": [[n[:160], s] for n, s in st.gaps[:top]]}
