"""Where the port's host time and the device's idle time go, by the
program's own spans (interactron_tpu_torch/utils/profiling.py), on the card.

    python3 tools/span_report.py --workload interactron_scaled.train.b16 --seed 5 \
        [--syncs] [--gaps] [--cost 3] [--window 20]

`--workload` names a benchmark cell, or `<config>.<traffic>` of the
benchmark's configurations and traffic mixes (e.g. interactron.train.b16).
The cell is built as the benchmark builds it (portbench/drivers: weights
made from the seed on the card, the JPEG tree and its loader or the served
frames, the warm-up), then:

  --syncs  one step or chunk under torch.cuda.set_sync_debug_mode("warn"):
           each synchronising call's site in the program, how often it ran,
           and whether a `sync.*` span covered it; the recorder's `syncs`,
           `h2d_bytes` and `graphs.*` beside them. Warnings raised in the autograd
           engine's threads go to the standard error, and are counted.
  --gaps   one step or chunk under torch.profiler (CPU and CUDA), the
           recorder off as in the benchmark's profiled stretch, and then one
           with it on: the device's idle time by the innermost program span
           open on the dispatching thread (and by the outermost), the device
           time of the kernels each span launched, the host's self time by
           span, and how far the recorder's spans lie from their
           annotations on the profiler's timeline.
  --cost N N alternating pairs of `--window` second windows of the cell's
           traffic, recorder off and on (off, on, on, off, ...), with the
           rate of each.

`--first-step` skips the train driver's three set-up steps, so that
`--syncs` checks the program's first step (interactron.train.b16, whose
later bf16 steps go non-finite). Prints one JSON line per part. Needs the
card. The set-up line lists the CUDA graphs the program captured in the
warm-up (module, input shapes, pieces), and the `host` and `syncs` lines
the calls replayed, captured and run eagerly.
"""

import argparse
import bisect
import itertools
import json
import os
import sys
import tempfile
import time
import traceback
import warnings

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from interactron_tpu_torch.utils import profiling  # noqa: E402
from portbench.lib import bench  # noqa: E402

PKG = os.path.join(ROOT, "interactron_tpu_torch") + os.sep
OUTSIDE = "(outside program spans)"


def out(kind, **kw):
    print(json.dumps({"part": kind, **kw}), flush=True)


def build(name, seed, first_step=False):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    workload = next((w for w in spec["workloads"] if w["name"] == name), None)
    if workload is None:
        config, traffic = name.split(".", 1)
        workload = {"name": name, "config": config, "traffic": traffic, "chips": 1}
    # nothing is compared here: the limits are never read
    run = bench.Run(spec, workload, seed, 20.0, False, torch.device("cuda", 0),
                    limits={"unused": 0.0})
    driver = bench.load_module(os.path.join(ROOT, "portbench", "drivers",
                                            run.traffic["driver"] + ".py"), "driver")
    if first_step:
        driver._three_steps = lambda *a: None
    t0 = time.perf_counter()
    driver.setup(run)
    run.sync()
    unit = ((lambda: driver._step(run)) if run.traffic["driver"] == "train"
            else (lambda: driver._chunk(run)))
    episodes = run.traffic.get("batch") or run.traffic["chunk"]
    out("setup", workload=name, seconds=time.perf_counter() - t0,
        gpu=bench.host_facts()["gpu"], torch=torch.__version__, graphs=graphs(run))
    return run, driver, unit, episodes


def graphs(run):
    """The CUDA graphs the program holds after set-up (utils/cuda_graphs.py):
    [module, its inputs' shapes, pieces] of each captured pass."""
    held = []
    for task in run.objects.values():
        cache = getattr(task, "_graphs", None)
        names = {id(m): n for n, m in getattr(task, "named_modules", lambda: ())()}
        for key, (_, graph) in getattr(cache, "entries", {}).items():
            if graph is not None:
                held.append([names.get(key[0], "?"), [list(k[0]) for k in key[2]],
                             graph.pieces()])
    return held


def graph_counts(counters):
    """The recorder's graphs.* counters: calls replayed, captured, eager."""
    return {k: counters.get(f"graphs.{k}", 0) for k in ("replays", "captures", "eager")}


def _site(stack):
    """The innermost frame in the program's package, else the innermost
    outside the warnings machinery."""
    frames = [f for f in stack if not f.filename.endswith(("warnings.py", "span_report.py"))]
    for f in reversed(frames):
        if f.filename.startswith(PKG):
            return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"
    f = frames[-1]
    return f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}"


def syncs(run, unit, episodes):
    """The synchronising calls of one step or chunk, by program site."""
    sites = {}
    shown = warnings.showwarning

    def note(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        stack = profiling._stack()
        covered = bool(stack) and stack[-1].name.startswith("sync.")
        key = _site(traceback.extract_stack()[:-1])
        entry = sites.setdefault(key, {"calls": 0, "covered": 0, "op": str(message)[:90]})
        entry["calls"] += 1
        entry["covered"] += covered

    run.sync()
    err = tempfile.TemporaryFile(mode="w+")
    saved = os.dup(2)
    profiling.take()
    profiling.enable(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            os.dup2(err.fileno(), 2)
            torch.cuda.set_sync_debug_mode("warn")
            unit()
            torch.cuda.set_sync_debug_mode(0)
    finally:
        os.dup2(saved, 2)
        os.close(saved)
        profiling.enable(False)
    run.sync()
    err.seek(0)
    other_threads = sum("called a synchronizing" in line for line in err)
    rec = profiling.take()
    spans = {}
    for s in rec["spans"]:
        if s.name.startswith("sync."):
            spans[s.name] = spans.get(s.name, 0) + 1
    out("syncs", episodes=episodes,
        sites=dict(sorted(sites.items(), key=lambda kv: -kv[1]["calls"])),
        warned=sum(v["calls"] for v in sites.values()),
        warned_in_program=sum(v["calls"] for k, v in sites.items() if k.startswith("interactron")),
        covered=sum(v["covered"] for v in sites.values()),
        other_threads=other_threads, recorder_syncs=rec["counters"].get("syncs", 0),
        h2d_bytes=rec["counters"].get("h2d_bytes", 0), sync_spans=spans,
        graphs=graph_counts(rec["counters"]))


def _program_spans(events, names):
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and e.is_user_annotation and e.name in names]


def _kernels(events):
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def _segments(spans, lo, hi):
    """[(start, end, innermost, outermost span name)] tiling [lo, hi] by
    the spans open there (properly nested: one thread), OUTSIDE where none
    is."""
    marks = sorted([(sp.time_range.start, 1, sp.name) for sp in spans]
                   + [(sp.time_range.end, 0, sp.name) for sp in spans])
    segs, stack, prev = [], [], lo
    for t, kind, name in marks + [(hi, 0, None)]:
        if t > prev:
            segs.append((prev, t, stack[-1] if stack else OUTSIDE,
                         stack[0] if stack else OUTSIDE))
            prev = t
        if kind == 1:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    return segs


def _idle(kernels, lo, hi):
    """The intervals of [lo, hi] in which no kernel runs."""
    idle, t = [], lo
    for s, e in sorted((k.time_range.start, k.time_range.end) for k in kernels):
        if s > t:
            idle.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        idle.append((t, hi))
    return idle


def _by_span(segs, intervals):
    """{innermost: us}, {outermost: us} of the intervals' overlap with the
    segments (both sorted)."""
    inner, outer, i = {}, {}, 0
    for s, e in intervals:
        while i < len(segs) and segs[i][1] <= s:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < e:
            d = min(e, segs[j][1]) - max(s, segs[j][0])
            if d > 0:
                inner[segs[j][2]] = inner.get(segs[j][2], 0.0) + d
                outer[segs[j][3]] = outer.get(segs[j][3], 0.0) + d
            j += 1
    return inner, outer


def _device_by_span(segs, events):
    """{innermost span: device us} of the kernels each op launched, by the
    span open on the dispatching thread when the op began (the backward's
    ops run on the autograd engine's thread while the dispatching thread
    waits in autograd.grad)."""
    starts = [sg[0] for sg in segs]
    out = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        k = bisect.bisect_right(starts, e.time_range.start) - 1
        name = segs[k][2] if 0 <= k and e.time_range.start < segs[k][1] else OUTSIDE
        out[name] = out.get(name, 0.0) + sum(x.duration for x in e.kernels)
    return out


def gaps(run, unit, episodes):
    """Idle time by span over one profiled step or chunk, recorder off."""
    from torch.profiler import ProfilerActivity, profile

    profiling.take()
    profiling.enable(True)
    unit()  # the span names this path opens
    profiling.enable(False)
    names = {s.name for s in profiling.take()["spans"]}
    run.sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        unit()
        run.sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = _kernels(events)
    spans = _program_spans(events, names)
    roots = [s for s in spans if s.name in ("train.step", "serve.next_action", "serve.predict",
                                            "loader.wait")]
    main = {s.thread for s in roots}
    on_main = [s for s in spans if s.thread in main]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
            and e.thread in main]
    lo = min(e.time_range.start for e in host)
    hi = max(max(e.time_range.end for e in host), max(k.time_range.end for k in kernels))
    segs = _segments(on_main, lo, hi)
    inner, outer = _by_span(segs, _idle(kernels, lo, hi))
    busy = sum(k.time_range.elapsed_us() for k in kernels)
    ms = lambda d: {k: round(v / 1e3, 3) for k, v in sorted(d.items(), key=lambda kv: -kv[1])}
    out("gaps", episodes=episodes, wall_ms=wall * 1e3, span_ms=(hi - lo) / 1e3,
        busy_ms=busy / 1e3, idle_ms=sum(inner.values()) / 1e3, kernels=len(kernels),
        idle_by_innermost_ms=ms(inner), idle_by_root_ms=ms(outer),
        device_by_innermost_ms=ms(_device_by_span(segs, events)))
    # the recorder on: its host self times, and its spans on the profiler's clock
    profiling.take()
    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        unit()
        run.sync()
    profiling.enable(False)
    rec = profiling.take()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ann = {}
    for e in _program_spans(prof.events(), names):
        ann.setdefault(e.name, []).append(e)
    worst, matched = 0.0, 0
    by_name = {}
    for s in rec["spans"]:
        by_name.setdefault(s.name, []).append(s)
    for name, ours in by_name.items():
        theirs = sorted(ann.get(name, []), key=lambda e: e.time_range.start)
        if len(theirs) != len(ours):
            continue
        for s, e in zip(sorted(ours, key=lambda s: s.start_ns), theirs):
            d = abs(s.start_ns + rec["unix_offset_ns"] - (start_ns + e.time_range.start * 1e3))
            worst, matched = max(worst, d), matched + 1
    own = profiling.self_times(rec["spans"])
    self_ms = {}
    for s in rec["spans"]:
        self_ms[s.name] = self_ms.get(s.name, 0.0) + own[s.id] / 1e6
    out("host", episodes=episodes, spans=len(rec["spans"]), counters=rec["counters"],
        graphs=graph_counts(rec["counters"]),
        launches=len(rec["launches"]), clock_matched=matched, clock_worst_ms=worst / 1e6,
        self_ms={k: round(v, 3) for k, v in sorted(self_ms.items(), key=lambda kv: -kv[1])})


def _span_ns(on, n=100_000):
    """Host nanoseconds of one span with attrs, recording `on` or off."""
    profiling.take()
    profiling.enable(on)
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with profiling.span("overhead", episodes=1):
            pass
    dt = time.perf_counter_ns() - t0
    profiling.enable(False)
    profiling.take()
    return dt / n


def cost(run, driver, pairs, seconds):
    """Rates of alternating windows with the recorder off and on, and what
    one span costs the host."""
    run.seconds = seconds
    if hasattr(run, "order"):  # the served episodes' order, for windows past its end
        run.order = itertools.cycle(list(run.order))
    order = [False, True, True, False] * pairs
    rates = {False: [], True: []}
    per = {}
    for on in order[:2 * pairs]:
        profiling.take()
        profiling.enable(on)
        run.window = {}
        driver.window(run)
        profiling.enable(False)
        rec = profiling.take()
        rates[on].append(run.window["episodes"] / run.window["seconds"])
        if on:
            n = run.window.get("steps") or run.window["episodes"]
            per = {"spans_per_unit": len(rec["spans"]) / n,
                   "counters_per_unit": {k: v / n for k, v in rec["counters"].items()},
                   "unit": "step" if run.window.get("steps") else "episode"}
    out("cost", rates_off=rates[False], rates_on=rates[True], order=order[:2 * pairs],
        window_s=seconds, span_ns_on=_span_ns(True), span_ns_off=_span_ns(False), **per)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=5)
    p.add_argument("--syncs", action="store_true")
    p.add_argument("--gaps", action="store_true")
    p.add_argument("--cost", type=int, default=0)
    p.add_argument("--window", type=float, default=20.0)
    p.add_argument("--first-step", action="store_true",
                   help="skip the train driver's three set-up steps, so that --syncs "
                        "checks the program's first step (for a configuration whose "
                        "later bf16 steps go non-finite)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    run, driver, unit, episodes = build(args.workload, args.seed, args.first_step)
    if args.syncs:
        syncs(run, unit, episodes)
    if args.gaps:
        gaps(run, unit, episodes)
    if args.cost:
        cost(run, driver, args.cost, args.window)
    if hasattr(run, "batches"):
        run.batches.close()
    if hasattr(run, "tree"):
        import shutil

        shutil.rmtree(run.tree, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
