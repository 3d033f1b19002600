#!/usr/bin/env python3
"""The readings the comparison limits are set from, several seeds in one
process (the benchmark's own runs never run this).

    python3 portbench/readings.py --workload <name> --seeds 11,12,... --mode program|control|half_batch [--seconds s]

`program`: the program's compared path on each seed (train: set-up's three
steps; serve: set-up and a window of `--seconds`) against the fp32
reference: the lower readings. `control`: the reference in fp8 in the
program's place: the upper readings. `half_batch` (train) and
`fast_unstepped` (serve): the program with that fault planted (see the
drivers). One JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench.lib import bench  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", choices=("program", "control", "half_batch", "fast_unstepped"),
                   default="program")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    spec = bench._json(ROOT, "BENCHMARK.json")
    workload = next(w for w in spec["workloads"] if w["name"] == args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = bench.Run(spec, workload, seed, args.seconds, False, device)
        driver = bench.load_module(os.path.join(ROOT, "portbench", "drivers",
                                                run.traffic["driver"] + ".py"), "driver")
        if args.mode == "control":
            driver.control(run)
        else:
            run.fault = None if args.mode == "program" else args.mode
            driver.setup(run)
            if run.traffic["driver"] == "serve":
                driver.window(run)
        numbers = driver.check(run)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          **{n: v for n, v, _ in numbers}, "extra": run.extra}), flush=True)
        del run, driver
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    found = bench.forbidden_modules()
    if found:
        print(f"JAX modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
