"""Device time of the deformable attention kernels (ops/ms_deform_attn.py) at
the served path's launch shapes, beside their least time, their plain
version's and the published grid_sample core's (forward, and its autograd
backward for the backward kernel: the same function's three gradients; the
yardstick, the port never calls it), on the card.

    python3 tools/bench_msda.py [--dtype bfloat16] [--iters 50]

Shapes: a lockstep chunk's encoder (50 frames, Lq = S = 1930: 38x38,
19x19, 10x10, 5x5) and decoder (Lq = 300) launches, and one served frame's
encoder. Each time is the mean over `--iters` launches between CUDA
events, after a warm-up, with the launches queued behind
`torch.cuda._sleep` so the host's enqueueing is not timed. Prints one JSON
line per shape, and the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from interactron_tpu_torch.ops import ms_deform_attn as op  # noqa: E402
from portbench.lib import msda  # noqa: E402
from portbench.reference.ms_deform_attn import ms_deform_attn as grid_sample_core  # noqa: E402

LEVELS = ((38, 38), (19, 19), (10, 10), (5, 5))
SHAPES = [("encoder.chunk", 50, 1930), ("decoder.chunk", 50, 300), ("encoder.frame", 1, 1930)]


def timed_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))  # the queue fills before the first launch runs
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)
    dt = getattr(torch, args.dtype)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__, "dtype": args.dtype}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    h, d, p_ = 8, 32, 4
    s = sum(a * b for a, b in LEVELS)
    for name, n, lq in SHAPES:
        value = torch.randn(n, s, h * d, generator=g, device="cuda").to(dt)
        # offsets of a few pixels around each query's point, as at init
        loc = torch.rand(n, lq, h, 1, 1, 2, generator=g, device="cuda") + 0.02 * torch.randn(
            n, lq, h, len(LEVELS), p_, 2, generator=g, device="cuda")
        w = torch.softmax(torch.randn(n, lq, h, len(LEVELS) * p_, generator=g, device="cuda"),
                          -1).view(n, lq, h, len(LEVELS), p_)
        go = torch.randn(n, lq, h * d, generator=g, device="cuda").to(dt)
        shape = (n, lq, s, h, d, len(LEVELS), p_, value.element_size())
        row = {"shape": name, "N": n, "Lq": lq, "S": s,
               "fwd_ms": timed_ms(lambda: op.ms_deform_attn_fwd(value, LEVELS, loc, w), args.iters),
               "bwd_ms": timed_ms(lambda: op.ms_deform_attn_bwd(value, LEVELS, loc, w, go),
                                  args.iters),
               "fwd_bound_ms": 1e3 * msda.bound_s("msda_fwd", *shape),
               "bwd_bound_ms": 1e3 * msda.bound_s("msda_bwd", *shape),
               "plain_fwd_ms": timed_ms(lambda: op.ms_deform_attn_fwd_plain(value, LEVELS, loc, w),
                                        max(1, args.iters // 10)),
               "grid_sample_fwd_ms": timed_ms(lambda: grid_sample_core(value, LEVELS, loc, w),
                                              max(1, args.iters // 10)),
               "plain_bwd_ms": timed_ms(
                   lambda: op.ms_deform_attn_bwd_plain(value, LEVELS, loc, w, go),
                   max(1, args.iters // 10))}
        vg, lg, wg = (x.detach().clone().requires_grad_(True) for x in (value, loc, w))
        core = grid_sample_core(vg, LEVELS, lg, wg)
        row["grid_sample_bwd_ms"] = timed_ms(
            lambda: torch.autograd.grad(core, (vg, lg, wg), go.float(), retain_graph=True),
            max(1, args.iters // 10))
        print(json.dumps(row), flush=True)
        del value, loc, w, go, vg, lg, wg, core
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
