"""Build the CUDA kernels once, then let every rank go (the port's
counterpart of interactron_tpu/parallel/lockstep.py).

Multi-process programs race at startup. In the JAX package each process
compiles its program and the first to finish enters the collectives while
its peers are still in XLA. The port compiles its kernels with nvcc at
first use (ops/cuda_build.py), so under torchrun every rank of a node would
start the same eight nvcc at once on a cold `build/`, and the first rank
to finish would enter the gradient all_reduce while the others are still
in ptxas. `build_barrier` removes the race: local rank 0 of each node
builds, and every rank of the group waits for it before any kernel loads.
"""

import time

import torch.distributed as dist


def build_barrier(local_rank, build=None):
    """Local rank 0 runs `build` (`cuda_build.build_all` unless given); then
    every rank of the default group meets at an all_gather of the ranks'
    reports, so none goes on before every build has ended. A failed build
    fails every rank, instead of leaving its peers waiting. Returns the
    reports in rank order: {"rank", "local_rank", "built", "seconds",
    "error"}."""
    report = {"rank": dist.get_rank(), "local_rank": local_rank, "built": local_rank == 0,
              "seconds": 0.0, "error": None}
    cause = None
    if local_rank == 0:
        if build is None:
            from interactron_tpu_torch.ops.cuda_build import build_all as build
        t0 = time.perf_counter()
        try:
            build()
        except Exception as exc:  # reported to every rank, then raised on each
            cause = exc
            report["error"] = f"{type(exc).__name__}: {exc}"
        report["seconds"] = time.perf_counter() - t0
    reports = [None] * dist.get_world_size()
    dist.all_gather_object(reports, report)
    failed = [r for r in reports if r["error"]]
    if failed:
        raise RuntimeError(f"kernel build failed on rank {failed[0]['rank']}: "
                           f"{failed[0]['error']}") from cause
    return reports
