"""Reductions the metric readers share. A reader returns None where its
run has nothing to read, and the metric is then left out of the line."""

from portbench.lib import roofline


def span_per(run, name, per):
    """Milliseconds of span `name` over `per` ("calls", "steps" or
    "episodes" of the window): a mean a call, or a sum a step."""
    spans = run.spans.get(name)
    if not spans:
        return None
    n = len(spans) if per == "calls" else run.window.get(per, 0)
    return 1e3 * sum(spans) / n if n else None


def mfu(run, kind):
    """The useful FLOPs (the reference's count an episode, times the
    episodes) over the seconds and the bf16 peak, in %, of the traced run's
    half window with the spans off."""
    flops, w = run.flops.get(f"{kind}_episode"), run.quiet_window
    if not flops or not w or not w.get("episodes"):
        return None
    return 100.0 * flops * w["episodes"] / w["seconds"] / roofline.PEAK_FLOPS


def idle_share(run):
    st = run.stretch
    if st is None or not st.kernels or st.wall_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.wall_s)


def launches_per_episode(run):
    st = run.stretch
    return None if st is None or not st.kernels else st.kernels / st.episodes


def fwconv_roofline(run, kind):
    """The fast weights' conv work of the stretch's episodes over the device
    time of their kernels and the bf16 peak, in %."""
    st, flops = run.stretch, run.flops.get(f"fwconv_{kind}_episode", 0)
    if st is None or not flops or st.conv_s <= 0:
        return None
    return 100.0 * flops * st.episodes / st.conv_s / roofline.PEAK_FLOPS


def attn_roofline(run):
    """Sum of the attention launches' least times at their shapes over the
    device time of those kernels, in %; None when no attention kernel ran
    or the device kernels do not match the recorded launches one to one."""
    st = run.stretch
    if st is None or not st.launches:
        return None
    device_s, device_n = 0.0, 0
    for name, (count, secs) in st.by_name.items():
        if roofline.kernel_of(name) is not None:
            device_s += secs
            device_n += count
    if device_n != len(st.launches) or device_s <= 0:
        return None
    bound = sum(roofline.bounds(b, t, s, h, d, elt, rate)[name]
                for name, b, t, s, h, d, elt, rate in st.launches)
    return 100.0 * bound / device_s
