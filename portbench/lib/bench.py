"""The benchmark's run: one cell, one seed, one window.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything particular to a cell is data found by name: the workload's
entry in BENCHMARK.json names a configuration (`portbench/configs/<name>.json`:
the port's YAML config, its source, its FLOP counts) and a traffic mix
(`portbench/traffic/<name>.json`: the driver, `portbench/drivers/<driver>.py`,
and its parameters); each metric is a reader, `portbench/metrics/<name>.py`;
each cell's comparison limits are `portbench/limits/<workload>.json`.

A run: set-up (the program built, weights made from the seed on the card,
inputs written, every shape warmed up; `setup_s`), the window (`--seconds`
of the cell's traffic; with `--trace 1` its first half with the spans
off, its second with the readers' spans on, then one profiled stretch), the peak memory, then the comparison with the plain
reference, which decides `correct`, and the check that no JAX module was
loaded. The last line of standard output is the result; the numbers
compared, each with its limit, are the last lines of standard error.
"""

import argparse
import importlib.util
import json
import os
import platform
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "interactron_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, flax's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def host_facts():
    """CPU model, cores, load average, and the card's clocks and power."""
    model = platform.processor() or platform.machine() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            model = next(l.split(":", 1)[1].strip() for l in f
                         if l.split(":")[0].strip() in ("model name", "Model name", "cpu model"))
    except (OSError, StopIteration):
        pass
    facts = {"cpu": model, "cores": os.cpu_count(),
             "cores_usable": len(os.sched_getaffinity(0)), "loadavg": list(os.getloadavg())}
    try:
        facts["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,clocks.mem,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        facts["gpu"] = f"nvidia-smi: {e}"
    return facts


class Run:
    """What a driver and the readers share: the cell's data, the device,
    the spans (seconds by name, recorded while `tracing`), the window's
    records (in a traced run its second half's; `quiet_window` holds the
    first half's, run with the spans off) and the profiled stretch."""

    def __init__(self, spec, workload, seed, seconds, trace, device, root=ROOT, config=None,
                 traffic=None, limits=None):
        self.spec = spec
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.root = root
        cfg_entry = next(c for c in spec["configs"] if c["name"] == workload["config"])
        self.config = config or _json(root, cfg_entry["file"])
        self.traffic = traffic or _json(root, "portbench", "traffic", workload["traffic"] + ".json")
        self.limits = limits or _json(root, "portbench", "limits", workload["name"] + ".json")
        self.model_config = self.config["config"]
        self.flops = self.config["flops"]
        self.tracing = False
        self.spans = {}
        self.window = {}
        self.quiet_window = None
        self.stretch = None
        self.setup_s = None
        self.objects = {}
        self.fault = None  # a planted fault, for the tests of the comparison

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def record(self, name, seconds):
        self.spans.setdefault(name, []).append(seconds)

    def span(self, obj, attr, name):
        """Wrap `obj.attr` (a callable) so that while `tracing` each call is
        timed between two synchronisations under `name`."""
        inner = getattr(obj, attr)

        def timed(*a, **kw):
            if not self.tracing:
                return inner(*a, **kw)
            self.sync()
            t0 = time.perf_counter()
            try:
                return inner(*a, **kw)
            finally:
                self.sync()
                self.record(name, time.perf_counter() - t0)

        setattr(obj, attr, timed)


def metric_entries(spec, workload, trace):
    """The metrics a run of `workload` reports: the end-to-end ones without
    trace, the per-layer ones with it; an entry with `workloads` only in
    those cells."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if "workloads" not in m or workload["name"] in m["workloads"]]


def readers(spec, workload, trace, root=ROOT):
    return [(m, load_module(os.path.join(root, "portbench", "metrics", m["name"] + ".py"),
                            "portbench_metric_" + m["name"].replace(".", "_")))
            for m in metric_entries(spec, workload, trace)]


def execute(run):
    """Set-up, window, stretch, comparison; returns (result dict or None,
    the numbers compared)."""
    import torch

    t0 = time.perf_counter()
    driver = load_module(os.path.join(run.root, "portbench", "drivers",
                                      run.traffic["driver"] + ".py"), "portbench_driver")
    mods = readers(run.spec, run.workload, run.trace, run.root)
    driver.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - t0
    log(f"set-up {run.setup_s:.3f} s")
    log("host " + json.dumps(host_facts()))
    for _, mod in mods:
        if hasattr(mod, "instrument"):
            mod.instrument(run)
    if run.trace:
        # the first half of the window with the spans off, for the rates
        # that the spans' synchronisations would lower (mfu), then the
        # second half with them on
        seconds, run.seconds = run.seconds, run.seconds / 2
        driver.window(run)
        run.quiet_window, run.window = run.window, {}
        run.tracing = True
        driver.window(run)
        run.tracing = False
        run.seconds = seconds
        for k in ("attempted", "failed"):
            run.window[k] += run.quiet_window[k]
    else:
        driver.window(run)
    if run.trace:
        run.stretch = driver.stretch(run)
    log("host " + json.dumps(host_facts()))
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    metrics = {}
    for entry, mod in mods:
        value = mod.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    log(f"window {json.dumps({k: v for k, v in run.window.items() if k != 'latencies'})}")
    numbers = driver.check(run)
    log("not compared " + json.dumps(getattr(run, "extra", {})))
    correct = all(v <= lim for _, v, lim in numbers)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": int(run.workload["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(run.window["attempted"]),
              "failed": int(run.window["failed"]), "metrics": metrics, "device": device}
    if run.trace and run.stretch is not None:
        from portbench.lib.profile import breakdown

        device["busy_s"] = run.stretch.busy_s
        device["window_s"] = run.stretch.wall_s
        result["breakdown"] = breakdown(run.stretch)
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    return result, numbers


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    workload = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if workload is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(workload["chips"]):
        log(f"needs {workload['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    run = Run(spec, workload, args.seed, args.seconds, args.trace, torch.device("cuda", 0))
    result, numbers = execute(run)
    found = forbidden_modules()
    if found:
        log(f"JAX modules loaded in this process: {found}")
        return 3
    for name, v, lim in numbers:
        log(f"compared {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0
