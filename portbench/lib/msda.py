"""The deformable attention kernels' least time at a launch's shapes, and the
readers of their roofline share and busy share (`msda_roofline.serve`,
`msda_busy_share.serve`).

A launch's shapes are the program's own record (ops/ms_deform_attn.py keeps
(kernel, N, Lq, S, H, D, levels, points, value bytes) of each launch while
its recorder is on). The recorder is on in a traced run's second half
window, and off in the profiled stretch; a chunk of the served traffic
launches the same kernels at the same shapes every time, so the least time
of one episode is that of the window's launches over its episodes, and the
stretch's is that times its episodes. The device time is that of the
stretch's kernels by name, whose count must match the record's, episode for
episode.

Least time = max(FLOPs / 67 TFLOP/s, the fp32 rate outside the tensor
cores; compulsory bytes / 3.35 TB/s). FLOPs are those of each sample's
channels: the forward's bilinear blend (4 products, 3 sums) and weighted
sum (2), 9 a channel; the backward's blend again (9), the weight's
gradient product (1), the two location gradients (7 each) and the four
value gradients (2 each), 32 a channel. Compulsory bytes read each input
once and write each output once in its dtype: the value maps (every row a
head's samples can reach, at most all S), the float32 locations (8 bytes a
sample) and weights (4), the output or the output's gradient; the backward
also writes dValue in the value's dtype and dLocations and dWeights.
"""

import re

from portbench.lib import roofline, spans

PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
FLOPS_PER_CHANNEL = {"msda_fwd": 9, "msda_bwd": 32}
_NAME = re.compile(r"(?<![A-Za-z0-9_])msda_(fwd|bwd)_kernel(?![A-Za-z0-9_])")


def kernel_of(device_name):
    """`msda_fwd` or `msda_bwd` for a device kernel's (demangled) name, else None."""
    m = _NAME.search(device_name)
    return f"msda_{m.group(1)}" if m else None


def flops(kernel, n, lq, s, h, d, levels, points):
    return float(FLOPS_PER_CHANNEL[kernel] * n * lq * h * levels * points * d)


def compulsory_bytes(kernel, n, lq, s, h, d, levels, points, elt):
    samples = n * lq * h * levels * points
    rows = n * h * min(s, 4 * levels * points * lq)  # value rows the samples can reach
    queries = n * lq * h * d * elt  # the output, or its gradient
    if kernel == "msda_fwd":
        return float(rows * d * elt + samples * 12 + queries)
    return float(2 * rows * d * elt + 2 * samples * 12 + queries)


def bound_s(kernel, n, lq, s, h, d, levels, points, elt):
    return max(flops(kernel, n, lq, s, h, d, levels, points) / PEAK_FP32_FLOPS,
               compulsory_bytes(kernel, n, lq, s, h, d, levels, points, elt)
               / roofline.PEAK_BYTES)


def _record(run):
    """(the program's deformable launches, episodes) of the traced window,
    or None where the program recorded none."""
    rec, u = spans.record(run), spans.units(run, "serve")
    launches = (rec or {}).get("msda") or []
    return (launches, u[1]) if launches and u else None


def _device(run):
    """(seconds, count) of the stretch's deformable attention kernels."""
    st = run.stretch
    if st is None or not st.kernels:
        return 0.0, 0
    got = [(c, secs) for name, (c, secs) in st.by_name.items() if kernel_of(name)]
    return sum(s for _, s in got), sum(c for c, _ in got)


def roofline_share(run):
    """Sum of the least times of the stretch's launches over their device
    time, in %; None without a record, or where the stretch's kernels do not
    match the record's count episode for episode."""
    got = _record(run)
    device_s, device_n = _device(run)
    if got is None or device_s <= 0:
        return None
    launches, episodes = got
    st = run.stretch
    if device_n * episodes != len(launches) * st.episodes:
        return None
    per_episode = sum(bound_s(*launch) for launch in launches) / episodes
    return 100.0 * per_episode * st.episodes / device_s


def busy_share(run):
    """The stretch's deformable attention device time over its busy time,
    in %; None without the program's record."""
    device_s, _ = _device(run)
    if _record(run) is None or run.stretch is None or run.stretch.busy_s <= 0:
        return None
    return 100.0 * device_s / run.stretch.busy_s
