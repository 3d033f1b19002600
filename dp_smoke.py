#!/usr/bin/env python3
"""Episode data parallelism of the PyTorch/CUDA port across cards: NCCL
ranks, one a card, through `interactron_tpu_torch.parallel.mesh`.

    python3 dp_smoke.py --ranks 4              # four cards of one host
    python3 dp_smoke.py --ranks 2 --device cpu --steps 0   # gloo, a rehearsal

The parent starts one child a rank with torchrun's environment (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT on a free local port),
waits for all of them and exits non-zero if any fails. Each child:

  1. holds `data_parallel_grads` against one process: configs/interactron.yaml
     at chip_smoke.py's PARITY_DEPTH in fp32 with dropout off, seed 0's
     weights with FrozenBatchNorm statistics calibrated (rank 0's,
     broadcast), a batch of 2 episodes a rank; rank 0 also runs the whole
     batch in one process and holds the summed gradients and mean metrics
     to chip_smoke.py's phase 7b rule (10x the one-process step's own change
     when the frames move by 1e-6 relative, no less than GRAD_FLOOR); every
     rank's merged path state must equal rank 0's;
  2. times, with `--steps` > 0, the full-width bf16 train step (dropout on,
     the config's INNER_BATCH 4) on 4 episodes a rank: the plain step on
     the rank's own episodes and the data-parallel step (the same work plus
     the all_reduce of the gradients, metrics and path state), each the
     median of `--steps` after a warmup, and the all_reduce of the two
     gradient buckets alone, with CUDA events.
Rank 0 prints the card's name and power limit, then one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args, argv):
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *argv],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(args.ranks), LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
        for r in range(args.ranks)]
    try:
        codes = [p.wait(timeout=args.timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        print(f"dp_smoke: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


def rank_main(args):
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from interactron_tpu_torch.parallel import mesh
    from interactron_tpu_torch.tasks import InteractronTask
    from interactron_tpu_torch.utils import constants as C
    from interactron_tpu_torch.utils.config import Config, get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh.init_distributed(args.device)
    r, w = mesh.rank(), mesh.world_size()
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    base = get_config("configs/interactron.yaml").to_dict()
    out = {"world": w, "backend": dist.get_backend()}

    def shared_weights(cfg):
        """Rank 0's calibrated weights on every rank."""
        weights = cs.calibrated_weights(cfg, InteractronTask, Config, device=device)
        for v in weights.values():
            dist.broadcast(v, 0)
        return weights

    # 1. correctness against one process
    t0 = time.perf_counter()
    pcfg = json.loads(json.dumps(base))
    pcfg["MODEL"].update(cs.PARITY_DEPTH, DTYPE="float32")
    model = InteractronTask(Config(pcfg), device=device).load_weights(shared_weights(pcfg))
    n = 2
    batch = cs.synthetic_batch(7, n * w, pcfg["MODEL"]["NUM_CLASSES"], C)
    fi = [(i % 4) + 1 for i in range(n * w)]
    local = {k: v[r * n:(r + 1) * n] for k, v in batch.items()}
    g, m, state = mesh.data_parallel_grads(model)(
        local, torch.Generator().manual_seed(0), model.init_path_state(n * w), train=False,
        frame_index=fi[r * n:(r + 1) * n])
    for k in ("cost", "action"):
        ref = state[k].clone()
        dist.broadcast(ref, 0)
        if not torch.equal(ref, state[k]):
            raise AssertionError(f"rank {r}: merged path state {k} differs from rank 0's")
    if r == 0:
        norm = lambda d: sum(torch.sum(x.double() ** 2) for x in d.values()).sqrt().item()
        one = [model.grads_and_metrics(b, torch.Generator().manual_seed(0),
                                       model.init_path_state(n * w), train=False, frame_index=fi)
               for b in (batch, cs.perturbed(batch))]
        (gb, mb, sb), (gm, mm, _) = one
        out["grads"] = {}
        for grp in gb:
            err = norm({k: g[grp][k] - gb[grp][k] for k in gb[grp]}) / norm(gb[grp])
            sens = norm({k: gm[grp][k] - gb[grp][k] for k in gb[grp]}) / norm(gb[grp])
            tol = max(10 * sens, cs.GRAD_FLOOR)
            out["grads"][grp] = {"rel_err": err, "tol": tol}
            if not err <= tol:
                raise AssertionError(f"{grp} gradient over {w} ranks: {err} > {tol}")
        out["loss_rel_err"] = max(abs(float(m[k]) - float(mb[k])) / abs(float(mb[k]))
                                  for k in mb if "loss" in k)
        if not torch.equal(state["action"], sb["action"]):
            raise AssertionError("merged path actions differ from the one-process step's")
    out["correctness_s"] = time.perf_counter() - t0
    del model

    # 2. timing of the full-width bf16 step
    if args.steps > 0:
        task = InteractronTask(Config(base), device=device).load_weights(shared_weights(base))
        b4 = cs.synthetic_batch(11 + r, 4, base["MODEL"]["NUM_CLASSES"], C)
        dp = mesh.data_parallel_grads(task)
        gen = torch.Generator().manual_seed(3)

        def median_ms(fn):
            times = []
            for i in range(args.steps + 1):
                sync()
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                sync()
                if i:
                    times.append(1e3 * (time.perf_counter() - t0))
            return float(np.median(times)), times

        state4 = task.init_path_state(4 * w)
        out["plain_step_ms"], out["plain_steps"] = median_ms(
            lambda: task.grads_and_metrics(b4, gen, state4, train=True))
        out["dp_step_ms"], out["dp_steps"] = median_ms(lambda: dp(b4, gen, state4, train=True))
        grads, _, _ = task.grads_and_metrics(b4, gen, state4, train=True)
        out["grad_bytes"] = sum(4 * x.numel() for d in grads.values() for x in d.values())
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            mesh.sum_grads(grads)
            sync()
            start.record()
            for _ in range(5):
                mesh.sum_grads(grads)
            end.record()
            sync()
            out["all_reduce_ms"] = start.elapsed_time(end) / 5
        out["episodes_per_s"] = 4 * w * 1e3 / out["dp_step_ms"]
    gathered = [None] * w
    dist.all_gather_object(gathered, out)
    mesh.shutdown_distributed()
    if r == 0:
        if cuda:
            print(cs.device_line(), flush=True)
        print(json.dumps({"ranks": gathered}), flush=True)
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    parser.add_argument("--steps", type=int, default=3,
                        help="timed full-width train steps a rank (0: correctness only)")
    parser.add_argument("--timeout", type=float, default=1500)
    argv = sys.argv[1:] if argv is None else argv
    args = parser.parse_args(argv)
    if "RANK" in os.environ:
        return rank_main(args)
    if args.device == "cuda":
        import torch

        from interactron_tpu_torch.ops import cuda_build

        if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
            print(f"dp_smoke: needs {args.ranks} CUDA devices", file=sys.stderr)
            return 1
        cuda_build.build_all()  # once, before the ranks load the kernels
    return spawn(args, argv)


if __name__ == "__main__":
    sys.exit(main())
