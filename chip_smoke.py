#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (interactron_tpu_torch) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no "ok" line):
  1. device line (nvidia-smi name and power limit); TF32 off for fp32 work;
  2. build every CUDA kernel of the paths from interactron_tpu_torch/csrc/,
     one nvcc per library, all at once, with each library's build time and
     ptxas registers; what the kernels compiled to (cuobjdump -sass: the
     split formulation's four bf16 kernels, flash_dq, flash_dkv,
     flash_so_row and flash_so_col, on HGMMA and UTMALDG with no RED, ATOM
     or UTMAREDG; the mask kernel's 16-byte stores, no call);
  3. each kernel against its plain PyTorch version at the paths' shapes, in
     fp32 and bf16, at dropout rate 0 and 0.1 (the mask kernel bit for bit),
     with its device time beside the plain version's, one PyTorch library
     call's where one computes the same function
     (F.scaled_dot_product_attention, a yardstick only) and the bound (see
     `bound_ms`), and at the fusion shape the host time per call of the
     redesigned kernels (the seven on wgmma and TMA: flash_fwd, flash_bwd,
     flash_dq, flash_dkv, flash_so, flash_so_row, flash_so_col; and the
     mask); the split formulation's kernels also against the merged ones,
     and twice with equal outputs; the shapes include a train microbatch of
     4 episodes and a lockstep chunk of 10 (forward, and backward where the
     path runs one: SHAPE_KERNELS); (b) those seven kernels at ragged shapes
     that end inside their 64-row tiles;
  4. full-width fp32 `predict` of configs/interactron.yaml (seed 0): the card
     against the CPU, which runs the plain versions; (b) at PARITY_DEPTH, a
     batched predict of 2 episodes against the same episodes one at a time
     on the card and against the CPU's batched predict;
  5. the served path in bf16: 4 episodes of next_action at s=1..4 and then
     predict, in the evaluator's order, one at a time, then 20 in lockstep
     chunks of 10 (one batched call per prefix length and one predict a
     chunk), with the kernel launch counters checked against the counts the
     path must make, and the episodes/s of both;
  6. device time by kernel over one bf16 predict and one lockstep predict
     of 10 (torch.profiler), with the fast weights' convolutions in the
     formulation they run (every trainable k>1 conv, forward and backward:
     the shifted GEMMs of the default MODEL.SHIFT_CONV on the fast-weight
     passes, the grouped conv on the inner pass);
  7. one full-width fp32 episode of the second-order meta-train step
     (`grads_and_metrics`, dropout on) at TRAIN_PARITY_DEPTH (3 encoder, 3
     decoder, 2 fusion layers): the card against the CPU; (b) at
     PARITY_DEPTH with dropout off, a train step of 2 episodes at
     INNER_BATCH 2 against INNER_BATCH 1 on the card and against the CPU;
  8. bf16 training: 3 optimizer steps of 4 episodes at the config's
     INNER_BATCH 4 (one microbatch a step; the config's batch of 16 cut to 4
     for time), then one step at INNER_BATCH 1, dropout at the config's
     rates, with the launch counters checked against the counts the train
     path must make; the regions its mask launches request, with their
     counts, and the mask kernel timed at the largest module-dropout region
     among them;
  9. device time by kernel over one bf16 train step (torch.profiler), with
     the fast weights' convolutions as in phase 6;
 10. the split formulation (FLASH_BWD=split SO_MERGED=0): fp32 split vs
     merged on the card (inner gradient, second-order probe, one train
     episode); bf16 served episodes and train steps with their launch counts;
     one served episode with FLASH_DKV=blocked; a profiled train step;
 11. train and evaluate from disk (`train_from_disk`): the port's synthetic
     writer puts a JPEG tree in a temporary directory, and `Trainer.train`
     runs over it at full width in bf16 (config cuts: batch 4, 2 epochs,
     SAVE_WINDOW 1; the config's INNER_BATCH and ROLLOUT_BATCH, the
     interactive evaluator in lockstep): the epoch-0 test
     epoch and closed-loop evaluation with AP, one train epoch whose steps
     launch what phase 8's do, checkpoints; `detector.ckpt` must predict
     `torch.equal` to the trained task, and a resume from `last_state.ckpt`
     restores the train state exactly and runs one more epoch. It logs the
     loader's, the train epoch's and the evaluation's episodes/s, the host
     scoring time, and the checkpoints' size and save and load times; (b)
     `python -m interactron_tpu_torch.train` on configs/interactron.yaml with
     only its DATASET, epoch, batch and output cuts, resuming from this
     phase's state, in a child process, after one bf16 step from the entry
     point's own seed-42 weights whose non-finite gradient leaves are
     counted; (c) the fp32 lockstep evaluation's predictions and records
     against the serial rollout's on the card, and a planted wrong pairing
     of episodes and fast weights that the hold must catch.
 12. the other shipped configurations (`other_configs`): interactron_random
     (FusionXAttn), single_frame_baseline (detr), multi_frame_baseline
     (detr_multiframe) and interactron_scaled (ViT-B/16 at 304 px), each
     (a) in fp32, card vs CPU, at a cut depth: predict and one train
     episode with dropout on; (b) in bf16 at full width from phase 11's tree:
     `Trainer.train` (batch 4, 2 epochs) with the config's trainer,
     INNER_BATCH and evaluator (the interactive one in lockstep at its
     default ROLLOUT_BATCH, held in fp32 (c) as phase 11c holds it), and
     three predicts, every launch count held
     against the module structure's; its episodes/s, predict ms and peak
     memory.
 13. pretrained weights and data parallelism (`pretrained_and_parallel`):
     (a) configs/interactron.yaml's MODEL.WEIGHTS pointed at a full-width
     reference-layout DETR-R50-DC5 + FusionGPT `.pth` (every converted leaf
     loaded torch.equal), one bf16 train step from it (its non-finite
     gradient leaves counted), the warning for a missing file, and a
     timm-layout ViT-B/16 at 224 px resized into interactron_scaled, its
     predict finite; (b) `data_parallel_grads` at world 1 over NCCL in a
     child under torchrun's environment, bit-equal to the plain step (split
     formulation, dropout off); (c) two gloo ranks on cuda:0 at PARITY_DEPTH
     in fp32 against the one-process step at phase 7b's tolerance, and their
     merged path states equal; (d) `python -m interactron_tpu_torch.train`
     at RANK 0 of WORLD_SIZE 1 from (a)'s `.pth` with phase 11's cuts, rank
     0's files written.
 14. the grid and the host modules (`grid_and_host`): (a) two gloo ranks
     share cuda:0 as dp 1 x tp 2 at full width with the class heads
     sharded over tp (`shard_heads`): fp32 predict, next_action and the
     inner step's gradients against one process, and a bf16 served episode
     with its launch counts and the predict's ms; (b) the kernel build
     barrier of `init_distributed`: local rank 0 builds, the other rank
     waits; (c) the native JPEG loader on phase 11's tree against the PIL
     path, with both paths' episodes/s.
 15. the fast-weight conv formulations and the memory switches
     (`formulations_and_switches`): (a) fp32, one fast-weight conv at
     layer4's shape in each formulation against the grouped conv (output,
     dX, per-episode dW); at PARITY_DEPTH, dropout off, the shifted-GEMM
     (the default), ADAPTED_IM2COL and IM2COL_CONV formulations each
     against the grouped conv (MODEL.SHIFT_CONV: False) on the card, a
     batched predict of 2 and a train step of 2 at INNER_BATCH 2 (phases
     4b's and 7b's rules); (b) fp32 at PARITY_DEPTH, dropout on,
     TRAINER.REMAT on and MODEL.REMAT_DROPOUT off against the defaults (7b's
     rule), and with each switch on the split formulation's step twice
     torch.equal (with cuDNN's deterministic algorithms, as 13(b)); (c)
     bf16 at full width, each formulation and switch: train ms a step,
     launches (held to the module structure's but under REMAT) and peak
     GiB, the same for a lockstep predict of 10, with device ms and the
     fast-weight convs' device ms profiled for the grouped, shift and
     ADAPTED_IM2COL cells; one layer4 conv timed in each formulation.
 16. (only when asked for, `--phases 16`) the profiles phase 15 leaves out:
     IM2COL_CONV's and TRAINER.REMAT's cells profiled, and REMAT's peak at a
     batch of 8 at INNER_BATCH 8, on and off.
Phases 1-9, 11 and 12 run the default (merged) formulation (but for phase
11's predict check, which runs split so that two runs are bitwise equal):
the switches are cleared first; phase 13(b) runs split.
Prints the kernels' JSON line, then {"ok": true, "device": {...}} last.
`--phases 3,13` (for development) runs phases 1 and 2 and the listed ones
and prints neither line; the default, all, is phases 3-15.
"""

import argparse
import contextlib
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
# 32-bit integer instructions/s of the CUDA cores: 132 SMs x 128 lanes x
# 1.98 GHz. An SM issues one warp instruction a clock on each of its four
# schedulers; the INT32 pipe (64 lanes an SM: xor, shift, add, compare)
# and the FMA pipe (multiplies, and adds, left shifts, high halves and
# carries as IMAD) run side by side at that rate together.
PEAK_INT_OPS = 33.4e12
# integer ops of one keep bit: the column's multiple (one add where the row
# part is hoisted), fmix32's two multiplies and three xor-shifts (the first
# xor three-way, with the row part), the compare, the bit's place in its
# word (csrc/dropout.cuh, csrc/dropout_mask.cu)
HASH_OPS = 11
RATE = 0.1  # the config's attention and residual dropout
SEED = 4321
# (name, B, T, S, H, D) of every attention the kernels serve on the path
SHAPES = [
    ("encoder_b5", 5, 361, 361, 8, 32),
    ("fusion", 1, 2060, 2060, 8, 64),
    ("fusion_last", 1, 255, 2060, 8, 64),
    # FusionXAttn's cross-attention: 255 queries over 1805 = 28 x 64 + 13 keys
    ("xattn", 1, 255, 1805, 8, 64),
    # the ViT-B/16 encoder of 5 frames at 304 px: 12 heads
    ("vit", 5, 361, 361, 12, 64),
    # the single-frame baseline's DETR encoder over a batch of 4 x 5 frames
    ("encoder_b20", 20, 361, 361, 8, 32),
    # a train microbatch of TRAINER.INNER_BATCH 4 episodes: FusionGPT, its
    # last block, FusionXAttn's cross-attention, the ViT-B/16 over 20 frames
    ("fusion_b4", 4, 2060, 2060, 8, 64),
    ("fusion_last_b4", 4, 255, 2060, 8, 64),
    ("xattn_b4", 4, 255, 1805, 8, 64),
    ("vit_b20", 20, 361, 361, 12, 64),
    # a lockstep chunk of 10 episodes (EVALUATOR.ROLLOUT_BATCH 10): predict's
    # DETR encoder over 50 frames and FusionGPT over 10 episodes (forward and
    # first-order backward), next_action's fusion at s = 4 (forward)
    ("encoder_b50", 50, 361, 361, 8, 32),
    ("fusion_b10", 10, 2060, 2060, 8, 64),
    ("fusion_s4_b10", 10, 1649, 1649, 8, 64),
]
# the kernels of the shapes whose paths run fewer than all seven
# attention kernels (REDESIGNED)
SHAPE_KERNELS = {"encoder_b50": ("fwd", "bwd"), "fusion_b10": ("fwd", "bwd"),
                 "fusion_s4_b10": ("fwd",)}
# (name, B, T, S, H, D) where T and S end inside the wgmma kernels' 64-row
# tiles
RAGGED = [
    ("ragged_1x1", 2, 1, 1, 8, 64),
    ("ragged_d32", 3, 65, 129, 8, 32),
    ("ragged_s255", 1, 2060, 255, 8, 64),
]
# the shapes where the split kernels run twice and must give equal outputs
REPRODUCED = ("fusion", "xattn", "vit", "encoder_b20", "fusion_b4", "vit_b20")
# the kernels whose bf16 instantiations run on wgmma and TMA: all seven
# attention kernels
REDESIGNED = ("fwd", "bwd", "dq", "dkv", "so", "so_row", "so_col")
# max abs error allowed, as a multiple of the reference's max abs value
TOL = {
    torch.float32: (1e-4, "fp32 in and out: summation order, exp2f of pre-scaled logits, "
                          "and the merged kernels' atomics in no fixed order"),
    torch.bfloat16: (2e-2, "outputs rounded to bf16 (2^-8 relative), P rounded to bf16 before "
                           "P.V and dV, dS before dK and dQ; reference is fp32 on the same "
                           "bf16 inputs"),
}
EPISODES = 4
CHUNK = 10  # phase 5's lockstep chunk: EVALUATOR.ROLLOUT_BATCH's default


def log(*a):
    print(*a, flush=True)


def device_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


SLEEP_HZ = 2e9  # cycles a second, above the H100's 1.98 GHz boost clock


def cuda_ms(fn, iters=20, warmup=3):
    """Device ms per call of `fn`. The timed calls are queued behind a
    sleeping kernel long enough to cover their enqueueing, so the events
    time the device's work back to back and not the host's: a wrapper's host
    cost (tens of microseconds) exceeds what a tensor-core kernel takes."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(SLEEP_HZ * (2 * iters * enqueue_s + 1e-4), 4e8)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=50):
    """Host ms per call of `fn`: the time to enqueue `iters` calls while the
    device is held by a sleeping kernel, so that no call waits for it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SLEEP_HZ * 0.2))
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    out = 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return out


def bound_ms(flops, nbytes, int_ops=0.0):
    """(least time in ms, "operations" or "bytes"): the larger of the bytes
    over HBM's rate and the operations over the peak of their type (bf16
    tensor-core FLOPs, 32-bit integer ops of the dropout hash)."""
    ops_s = max(flops / PEAK_FLOPS, int_ops / PEAK_INT_OPS)
    bytes_s = nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def bounds(b, t, s, h, d, elt, rate=0.0):
    """Least times (ms, by) of every attention kernel; with dropout each
    needs one keep bit per (T, S) element of every head. FLOPs are 2 per
    multiply-add of the (T x S x D) products each kernel must form."""
    qo, kv, rows = b * t * h * d, b * s * h * d, b * h * t
    hash_ops = HASH_OPS * b * h * t * s if rate > 0 else 0.0
    prod = 2.0 * b * h * t * s * d  # one (T x S x D) product
    return {
        # two products; in: q k v, out: O L
        "fwd": bound_ms(2 * prod, (2 * qo + 2 * kv) * elt + rows * 4, hash_ops),
        # five products; in: q k v O dO L, out: dq dk dv
        "bwd": bound_ms(5 * prod, (4 * qo + 4 * kv) * elt + rows * 4, hash_ops),
        # three products; in: q k v dO L D, out: dq
        "dq": bound_ms(3 * prod, (3 * qo + 2 * kv) * elt + 2 * rows * 4, hash_ops),
        # four products; in: q k v dO L D, out: dk dv
        "dkv": bound_ms(4 * prod, (2 * qo + 4 * kv) * elt + 2 * rows * 4, hash_ops),
        # twelve products; in: q dO A k v Bc C L D, out: c_q c_dO c_k c_v
        "so": bound_ms(12 * prod, (5 * qo + 6 * kv) * elt + 2 * rows * 4, hash_ops),
        # nine products; in: q dO A k v Bc C L D, out: c_q c_dO g_D s_gp
        "so_row": bound_ms(9 * prod, (5 * qo + 4 * kv) * elt + 4 * rows * 4, hash_ops),
        # eight products; in: q dO A k v Bc C L D g_D s_gp, out: c_k c_v
        "so_col": bound_ms(8 * prod, (3 * qo + 6 * kv) * elt + 4 * rows * 4, hash_ops),
    }


def mask_bound(n):
    """Least time of the mask kernel: one byte written per element, and the
    hash's integer ops."""
    return bound_ms(0.0, n, HASH_OPS * n)


# what the kernels must and must not compile to: (library, kernel symbol,
# SASS patterns that must appear, patterns that must not). The split
# formulation's four bf16 kernels write every output once, by the CTA that
# owns it, so two runs are bitwise equal: tensor cores and TMA loads, no
# atomic, reduction or TMA reduce-add.
_SPLIT = ((r"\bHGMMA\.", r"\bUTMALDG\b"), (r"\bRED\.", r"\bATOM", r"\bUTMAREDG\b"))
SASS_RULES = (
    ("flash_dq", "dq_wgmma_kernel", *_SPLIT),
    ("flash_dkv", "dkv_wgmma_kernel", *_SPLIT),
    ("flash_so_row", "so_row_wgmma_kernel", *_SPLIT),
    ("flash_so_col", "so_col_wgmma_kernel", *_SPLIT),
    ("dropout_mask", "mask_vec16_kernel", (r"\bSTG\.E[.\w]*\.128\b",), (r"\bCALL\b",)),
)


def sass_check(cuda_build):
    """Phase 2b, the standing guard of the split formulation's bitwise
    reproducibility: count SASS_RULES' patterns in each kernel's SASS
    (cuobjdump -sass of its library). Fails where a required pattern is
    missing or a forbidden one is there: an atomic or reduce in a split
    kernel, a subroutine call (a 64-bit division) in the mask kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for lib, kernel, want, never in SASS_RULES:
        sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(lib))], check=True,
                              capture_output=True, text=True, timeout=300).stdout
        body = "".join(f for f in sass.split("Function : ")[1:] if kernel in f.split("\n", 1)[0])
        counts = {p: len(re.findall(p, body)) for p in want + never}
        log(f"    {lib} SASS of {kernel}: " + ", ".join(f"{p} {n}" for p, n in counts.items()))
        if not body or not all(counts[p] for p in want) or any(counts[p] for p in never):
            raise AssertionError(f"{lib}: the SASS of {kernel} breaks its rules: {counts}")


def _randn(gen, b, h, d, dtype, lengths):
    """Seeded (b, n, h*d) inputs of `dtype` on the card, one per n of `lengths`."""
    return [torch.randn((b, n, h * d), device="cuda", generator=gen).to(dtype) for n in lengths]


def _check_errs(label, pairs, rel, why):
    """Hold each (key, got, ref[, floor]) to rel x max(max|ref|, floor)."""
    errs = {}
    for key, got, ref, *floor in pairs:
        err = (got.float() - ref).abs().max().item()
        tol = rel * max([ref.abs().max().item(), *floor])
        errs[key] = err
        held = f"{rel:g} x max|ref|" + (f" or x the floor {floor[0]:.3e}" if any(floor) else "")
        log(f"  {label} {key:10s} max_abs_err={err:.3e} tol={tol:.3e} ({held}: {why})")
        if not err <= tol:
            raise AssertionError(f"{label} {key}: {err} > {tol}")
    return errs


def check_kernels(fa):
    """Phase 3: kernel vs plain on the card at the paths' shapes, and the
    split formulation's kernels vs the merged ones. A shape listed in
    SHAPE_KERNELS holds and times only the kernels its path runs. Returns
    {(shape, dtype, rate): entry} with the errors, and in bf16 the times."""
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, t, s, h, d in SHAPES:
        kns = SHAPE_KERNELS.get(name, REDESIGNED)
        full = kns == REDESIGNED
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, a, bc, c = _randn(gen, b, h, d, dtype, (t, s, s, t, t, s, s))
            f32 = [x.float() for x in (q, k, v, do, a, bc, c)]
            rel, why = TOL[dtype]
            for rate in (0.0, RATE):
                seed = SEED if rate else 0
                drop = (rate, seed)
                o_ref, lse_ref = fa.flash_fwd_plain(*f32[:3], h, *drop)
                res_ref = (o_ref, lse_ref, f32[3], h, *drop)
                o, lse = fa.flash_fwd(q, k, v, h, *drop)
                res = (o, lse, do, h, *drop)
                pairs = [("O", o, o_ref), ("L", lse, lse_ref)]
                if "bwd" in kns:
                    bwd_ref = fa.flash_bwd_plain(*f32[:3], *res_ref)
                    bwd = fa.flash_bwd(q, k, v, *res)
                    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
                    og = fa.FlashAttention.apply(qg, kg, vg, h, *drop)
                    og.backward(do)
                    pairs += [("O_autograd", og, o_ref), ("dq", bwd[0], bwd_ref[0]),
                              ("dk", bwd[1], bwd_ref[1]), ("dv", bwd[2], bwd_ref[2]),
                              ("dq_autograd", qg.grad, bwd_ref[0])]
                if full:
                    delta_ref = fa._delta(f32[3], o_ref, h)
                    dq_ref = fa.flash_dq_plain(*f32[:3], *res_ref)
                    dkv_ref = fa.flash_dkv_plain(*f32[:3], *res_ref)
                    so_in_ref = (*f32, lse_ref, delta_ref)
                    so_ref = fa.flash_so_plain(*so_in_ref, h, *drop)
                    row_ref = fa.flash_so_row_plain(*so_in_ref, h, *drop)
                    col_ref = fa.flash_so_col_plain(*so_in_ref, *row_ref[2:], h, *drop)
                    dq = fa.flash_dq(q, k, v, *res)
                    dkv = fa.flash_dkv(q, k, v, *res)
                    # the second-order kernels on the plain version's L, D and
                    # row statistics, so that each check is of one kernel alone
                    so_in = (q, k, v, do, a, bc, c, lse_ref, delta_ref)
                    so = fa.flash_so(*so_in, h, *drop)
                    row = fa.flash_so_row(*so_in, h, *drop)
                    col = fa.flash_so_col(*so_in, *row_ref[2:], h, *drop)
                    col_own = fa.flash_so_col(*so_in, *row[2:], h, *drop)
                    pairs += [("dq_split", dq, dq_ref), ("dk_split", dkv[0], dkv_ref[0]),
                              ("dv_split", dkv[1], dkv_ref[1]),
                              ("c_q", so[0], so_ref[0]), ("c_k", so[1], so_ref[1]),
                              ("c_v", so[2], so_ref[2]), ("c_dO", so[3], so_ref[3]),
                              ("c_q_row", row[0], row_ref[0]), ("c_dO_row", row[1], row_ref[1]),
                              ("g_D", row[2], row_ref[2]), ("s_gp", row[3], row_ref[3]),
                              ("c_k_col", col[0], col_ref[0]), ("c_v_col", col[1], col_ref[1])]
                torch.cuda.synchronize()
                label = f"{name:12s} {str(dtype)[6:]:8s} rate {rate:g}"
                errs = _check_errs(label, pairs, rel, why)
                if full:
                    # the split composition against the merged kernels
                    _check_errs(label + " split vs merged", (
                        ("dq", dq, bwd[0].float()), ("dk", dkv[0], bwd[1].float()),
                        ("dv", dkv[1], bwd[2].float()), ("c_q", row[0], so[0].float()),
                        ("c_k", col_own[0], so[1].float()), ("c_v", col_own[1], so[2].float()),
                        ("c_dO", row[1], so[3].float())), rel, why)
                entry = {"errs": errs}
                if name in REPRODUCED and dtype == torch.bfloat16 and rate > 0:
                    again = (fa.flash_dq(q, k, v, *res), *fa.flash_dkv(q, k, v, *res),
                             *fa.flash_so_row(*so_in, h, *drop),
                             *fa.flash_so_col(*so_in, *row_ref[2:], h, *drop))
                    same = [torch.equal(x, y) for x, y in zip(again, (dq, *dkv, *row, *col))]
                    log(f"  {label} split kernels run twice, torch.equal per output: {same}")
                    if not all(same):
                        raise AssertionError(f"split kernels not reproducible: {same}")
                if dtype == torch.bfloat16:
                    timed = {
                        "fwd": (lambda: fa.flash_fwd(q, k, v, h, *drop),
                                lambda: fa.flash_fwd_plain(q, k, v, h, *drop)),
                        "bwd": (lambda: fa.flash_bwd(q, k, v, *res),
                                lambda: fa.flash_bwd_plain(q, k, v, *res)),
                    }
                    if full:
                        row_stats = row_ref[2:]
                        timed.update({
                            "dq": (lambda: fa.flash_dq(q, k, v, *res),
                                   lambda: fa.flash_dq_plain(q, k, v, *res)),
                            "dkv": (lambda: fa.flash_dkv(q, k, v, *res),
                                    lambda: fa.flash_dkv_plain(q, k, v, *res)),
                            "so": (lambda: fa.flash_so(*so_in, h, *drop),
                                   lambda: fa.flash_so_plain(*so_in, h, *drop)),
                            "so_row": (lambda: fa.flash_so_row(*so_in, h, *drop),
                                       lambda: fa.flash_so_row_plain(*so_in, h, *drop)),
                            "so_col": (lambda: fa.flash_so_col(*so_in, *row_stats, h, *drop),
                                       lambda: fa.flash_so_col_plain(*so_in, *row_stats, h,
                                                                     *drop)),
                        })
                    timed = {kn: fns for kn, fns in timed.items() if kn in kns}
                    for kn, (kern, plain) in timed.items():
                        entry[f"{kn}_ms"] = cuda_ms(kern)
                        entry[f"{kn}_plain_ms"] = cuda_ms(plain)
                        entry[f"{kn}_library_ms"] = None
                    if name == "fusion" and rate == 0.0:
                        for kn in REDESIGNED:
                            entry[f"{kn}_host_ms"] = host_ms(timed[kn][0])
                            log(f"  {label} flash_{kn} wrapper: host {entry[kn + '_host_ms']:.4f} "
                                f"ms per call, device {entry[kn + '_ms']:.4f} ms per call")
                    if rate == 0.0:
                        # SDPA has no dropout mask of ours and no double backward;
                        # its backward forms dq, dk and dv together, the yardstick
                        # of flash_bwd and of the flash_dq + flash_dkv pair
                        heads = lambda x, n: x.view(b, n, h, d).transpose(1, 2)
                        qh, kh, vh = heads(q, t), heads(k, s), heads(v, s)
                        entry["fwd_library_ms"] = cuda_ms(
                            lambda: F.scaled_dot_product_attention(qh, kh, vh))
                        if "bwd" in kns:
                            ql, kl, vl = (x.detach().clone().requires_grad_(True)
                                          for x in (qh, kh, vh))
                            ol = F.scaled_dot_product_attention(ql, kl, vl)
                            doh = heads(do, t)
                            entry["bwd_library_ms"] = cuda_ms(
                                lambda: torch.autograd.grad(ol, (ql, kl, vl), doh,
                                                            retain_graph=True))
                        if full:
                            entry["dq_library_ms"] = entry["bwd_library_ms"]
                            entry["dkv_library_ms"] = entry["bwd_library_ms"]
                    for kname, (bms, by) in bounds(b, t, s, h, d, 2, rate).items():
                        if kname in kns:
                            entry[f"{kname}_bound_ms"], entry[f"{kname}_bound_by"] = bms, by
                    log(f"  {label} times (ms): " + " | ".join(
                        f"{kn} {entry[kn + '_ms']:.4f} plain {entry[kn + '_plain_ms']:.4f} "
                        f"lib {entry[kn + '_library_ms'] or float('nan'):.4f} bound "
                        f"{entry[kn + '_bound_ms']:.4f} ({entry[kn + '_bound_by']})"
                        for kn in timed))
                results[(name, dtype, rate)] = entry
                del pairs, res, o, lse
            del q, k, v, do, a, bc, c, f32
        torch.cuda.empty_cache()

        # the keep mask of the shape's (B*H, T, S) region, bit for bit
        region = (b * h, t, s)
        mask = fa.dropout_mask(SEED, RATE, region, "cuda")
        ref = fa.dropout_mask_plain(SEED, RATE, region, device="cuda")
        sub = fa.dropout_mask(SEED, RATE, (2, 100, 77), "cuda", offsets=(b * h - 2, 40, 9))
        torch.cuda.synchronize()
        same = torch.equal(mask, ref) and torch.equal(sub, mask[-2:, 40:140, 9:86])
        keep = mask.float().mean().item()
        sigma = (RATE * (1 - RATE) / mask.numel()) ** 0.5
        mb, mby = mask_bound(mask.numel())
        entry = {"errs": {"mask": 0.0 if same else 1.0}, "keep_fraction": keep,
                 "mask_ms": cuda_ms(lambda: fa.dropout_mask(SEED, RATE, region, "cuda")),
                 "mask_plain_ms": cuda_ms(
                     lambda: fa.dropout_mask_plain(SEED, RATE, region, device="cuda")),
                 "mask_library_ms": None, "mask_bound_ms": mb, "mask_bound_by": mby}
        if name == "fusion":
            entry["mask_host_ms"] = host_ms(lambda: fa.dropout_mask(SEED, RATE, region, "cuda"))
            log(f"  {name:12s} dropout_mask wrapper: host {entry['mask_host_ms']:.4f} ms per "
                f"call, device {entry['mask_ms']:.4f} ms per call")
        log(f"  {name:12s} mask {region}: bit-exact {same}, keep fraction {keep:.6f} "
            f"(1 - rate = {1 - RATE:g}, sigma {sigma:.1e}); ms {entry['mask_ms']:.4f} plain "
            f"{entry['mask_plain_ms']:.4f} bound {mb:.4f} ({mby})")
        if not same or abs(keep - (1 - RATE)) > 6 * sigma:
            raise AssertionError(f"{name} dropout mask: bit-exact {same}, keep {keep}")
        results[(name, "mask")] = entry
        del mask, ref, sub
        torch.cuda.empty_cache()
    return results


def so_cancel_floors(fa, f32, h, rate):
    """With one key (S = 1) g_S, dS and g_dp of the second-order kernels
    cancel to zero (g_P against s_gp, dP against delta, g_dS against g_D),
    so c_q, c_k and c_v are rounding noise on both sides. Their floors are
    the sizes of the terms that cancel, through each output's products."""
    qh, kh, vh, doh, ah, bh, ch = (fa._heads(x, h) for x in f32)
    scale, inv = qh.shape[-1] ** -0.5, 1.0 / (1.0 - rate)
    mx = lambda x: x.abs().max().item()
    dp = inv * mx(doh @ vh.transpose(-1, -2))
    gds = scale * mx(ah @ kh.transpose(-1, -2) + qh @ bh.transpose(-1, -2))
    gp = inv * mx(doh @ ch.transpose(-1, -2)) + gds * dp
    return {"c_q": scale * (gp * mx(kh) + dp * mx(bh)),
            "c_k": scale * (gp * mx(qh) + dp * mx(ah)), "c_v": inv * gds * mx(doh)}


def check_ragged(fa):
    """Phase 3b: flash_fwd, flash_bwd, flash_dq, flash_dkv, flash_so,
    flash_so_row and flash_so_col (on the plain row statistics) against
    their plain versions where T and S end inside the kernels' 64-row
    tiles, with B > 1 (a tile's tail must not read the next batch
    element), in fp32 and bf16 at rates 0 and 0.1. With one key
    (S = 1) the softmax has no gradient: dq = dk = 0 exactly and both sides
    hold rounding noise of dS = P (dP - delta), where dP and delta cancel;
    there dq and dk (of both formulations) are held against the size of the
    terms that cancel, scale x max|dO v^T| x max|k| (max|q| for dk), and
    the second-order c_q, c_k, c_v against `so_cancel_floors`."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, b, t, s, h, d in RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, a, bc, c = _randn(gen, b, h, d, dtype, (t, s, s, t, t, s, s))
            f32 = [x.float() for x in (q, k, v, do, a, bc, c)]
            rel, why = TOL[dtype]
            cancel = 0.0  # the floor of dq's and dk's tolerance, over max|k| and max|q|
            if s == 1:
                dp = (fa._heads(f32[3], h) @ fa._heads(f32[2], h).transpose(-1, -2)).abs().max()
                cancel = dp.item() / d ** 0.5
            for rate in (0.0, RATE):
                drop = (rate, SEED if rate else 0)
                o_ref, lse_ref = fa.flash_fwd_plain(*f32[:3], h, *drop)
                res_ref = (o_ref, lse_ref, f32[3], h, *drop)
                dq_ref, dk_ref, dv_ref = fa.flash_bwd_plain(*f32[:3], *res_ref)
                dq_split_ref = fa.flash_dq_plain(*f32[:3], *res_ref)
                dk_split_ref, dv_split_ref = fa.flash_dkv_plain(*f32[:3], *res_ref)
                # the second-order kernels on the plain version's L and D
                so_in_ref = (*f32, lse_ref, fa._delta(f32[3], o_ref, h))
                so_ref = fa.flash_so_plain(*so_in_ref, h, *drop)
                row_ref = fa.flash_so_row_plain(*so_in_ref, h, *drop)
                col_ref = fa.flash_so_col_plain(*so_in_ref, *row_ref[2:], h, *drop)
                so_in = (q, k, v, do, a, bc, c, *so_in_ref[7:])
                so = fa.flash_so(*so_in, h, *drop)
                row = fa.flash_so_row(*so_in, h, *drop)
                col = fa.flash_so_col(*so_in, *row_ref[2:], h, *drop)
                floors = so_cancel_floors(fa, f32, h, rate) if s == 1 else {}
                so_pairs = [(key, got, ref,
                             floors.get(key.removesuffix("_row").removesuffix("_col"), 0.0))
                            for key, got, ref in zip(("c_q", "c_k", "c_v", "c_dO", "c_q_row",
                                                      "c_dO_row", "g_D", "s_gp", "c_k_col",
                                                      "c_v_col"),
                                                     (*so, *row, *col),
                                                     (*so_ref, *row_ref, *col_ref))]
                o, lse = fa.flash_fwd(q, k, v, h, *drop)
                res = (o, lse, do, h, *drop)
                dq, dk, dv = fa.flash_bwd(q, k, v, *res)
                dq_split = fa.flash_dq(q, k, v, *res)
                dk_split, dv_split = fa.flash_dkv(q, k, v, *res)
                torch.cuda.synchronize()
                label = f"{name:12s} {str(dtype)[6:]:8s} rate {rate:g}"
                q_floor = cancel * f32[1].abs().max().item()
                k_floor = cancel * f32[0].abs().max().item()
                _check_errs(label, (("O", o, o_ref), ("L", lse, lse_ref), ("dv", dv, dv_ref),
                                    ("dq", dq, dq_ref, q_floor), ("dk", dk, dk_ref, k_floor),
                                    ("dq_split", dq_split, dq_split_ref, q_floor),
                                    ("dk_split", dk_split, dk_split_ref, k_floor),
                                    ("dv_split", dv_split, dv_split_ref),
                                    *so_pairs), rel, why)


@contextlib.contextmanager
def mask_regions(fa, regions):
    """Count the region (n_bh, n_rows, n_cols) of every mask launch into
    `regions`; the wrapper counts its launches as before."""
    launch = fa._launch

    def counted(name, *args):
        if name == "dropout_mask":
            key = tuple(args[3:6])  # after the output pointer, seed and threshold
            regions[key] = regions.get(key, 0) + 1
        launch(name, *args)

    fa._launch = counted
    try:
        yield
    finally:
        fa._launch = launch


def module_mask(fa, regions, episodes):
    """After phase 8: log the mask regions its episodes requested, and hold
    and time the mask kernel at the largest module-dropout region among them
    (n_bh = 1, models/layers.py's Dropout)."""
    log(f"  mask regions of {episodes} train episodes ({sum(regions.values())} launches, "
        f"{sum(regions.values()) / episodes:g} an episode): " + ", ".join(
            f"{r} x{n}" for r, n in sorted(regions.items(), key=lambda rn: -np.prod(rn[0]))))
    region = max((r for r in regions if r[0] == 1), key=lambda r: r[1] * r[2])
    same = torch.equal(fa.dropout_mask(SEED, RATE, region, "cuda"),
                       fa.dropout_mask_plain(SEED, RATE, region, device="cuda"))
    mb, mby = mask_bound(region[1] * region[2])
    entry = {"errs": {"mask": 0.0 if same else 1.0}, "region": region,
             "mask_ms": cuda_ms(lambda: fa.dropout_mask(SEED, RATE, region, "cuda")),
             "mask_plain_ms": cuda_ms(
                 lambda: fa.dropout_mask_plain(SEED, RATE, region, device="cuda")),
             "mask_library_ms": None, "mask_bound_ms": mb, "mask_bound_by": mby}
    log(f"  largest module-dropout mask {region}: bit-exact {same}; ms {entry['mask_ms']:.4f} "
        f"plain {entry['mask_plain_ms']:.4f} bound {mb:.4f} ({mby})")
    if not same:
        raise AssertionError(f"module dropout mask {region} not bit-exact")
    return entry


def synthetic_frames(seed, s=5, size=300):
    """ImageNet-normalised (1, s, size, size, 3) float32 frames."""
    rng = np.random.RandomState(seed)
    img = rng.rand(1, s, size, size, 3).astype(np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (img - mean) / std


def calibrated_weights(config_dict, Task, Config, frames=None, device="cpu"):
    """Seed-0 random weights with every FrozenBatchNorm's statistics set to
    those of its input on a calibration batch, `frames` (n, H, W, 3), by
    default seeded noise frames, as pretrained statistics would be (the
    fp32 model runs on `device`). With identity statistics the random
    ResNet's activations grow through the trunk until the DETR encoder's
    first fp32 logits, and the gradients through them, are too
    ill-conditioned for a card vs CPU comparison to mean anything. A model
    without FrozenBatchNorm (the ViT backbone) keeps seed 0's weights."""
    from interactron_tpu_torch.models.layers import FrozenBatchNorm

    cfg = json.loads(json.dumps(config_dict))
    cfg["MODEL"].update(DTYPE="float32", WEIGHTS="")  # seed 0's draw, on purpose
    model = Task(Config(cfg), device=device).init(0)
    if not any(isinstance(m, FrozenBatchNorm) for m in model.modules()):
        return model.state_dict()

    def set_stats(mod, args):
        x = args[0].float()
        mod.running_mean.copy_(x.mean((0, 2, 3)))
        mod.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    if frames is None:
        frames = synthetic_frames(0)[0]
    with torch.no_grad():
        model.detector(model.frames({"frames": frames[None]})[0])
    for h in hooks:
        h.remove()
    return model.state_dict()


def full_width_parity(config_dict, Task, Config, weights):
    """Phase 4: fp32 inner gradient, detect and predict, card vs CPU.

    The adapted detect is far more sensitive to g than the forward is to
    its inputs: with random weights one step moves the logits by about
    their own range, and fp32 noise in g (conv-backward sums in another
    order, dQ atomics, ReLU masks that flip) moves the fast weights with
    it. So the forward is held tight on the same fast weights, g against
    the problem's own sensitivity to a 1e-6 relative change of the frames,
    and predict end to end against the size of the adaptation's effect."""
    cfg = json.loads(json.dumps(config_dict))
    cfg["MODEL"]["DTYPE"] = "float32"
    ep = {"frames": synthetic_frames(1, size=int(cfg["MODEL"].get("TEST_RESOLUTION", 300)))}
    res = {}
    for dev in ("cpu", "cuda"):
        model = Task(Config(cfg), device=dev).load_weights(weights)
        fast, g, prefix = model.adapt(ep)
        cpu_fast = fast if dev == "cpu" else res["cpu"]["fast"]
        with torch.no_grad():
            before = model.detr_apply(None, prefix[0:1], stage="from_prefix")
            same = model.detr_apply({k: v.to(dev) for k, v in cpu_fast.items()}, prefix[0:1],
                                    stage="from_prefix")["pred_logits"]
        pred = model.predict(ep)
        if dev == "cpu":
            # the problem's own sensitivity: g at frames moved by 1e-6 relative
            noise = np.random.RandomState(2).randn(*ep["frames"].shape).astype(np.float32)
            _, g_moved, _ = model.adapt({"frames": ep["frames"] * (1 + 1e-6 * noise)})
            g_moved = {k: v.cpu() for k, v in g_moved.items()}
        res[dev] = {"fast": {k: v.cpu() for k, v in fast.items()},
                    "g": {k: v.cpu() for k, v in g.items()},
                    "before": {k: before[k].cpu() for k in ("pred_logits", "pred_boxes")},
                    "same": same.cpu(), **{k: v.cpu() for k, v in pred.items()}}
        del model, fast, g
    c, r = res["cuda"], res["cpu"]
    gsq = lambda d: sum(torch.sum(x.double() ** 2) for x in d.values()).sqrt().item()
    g_err = gsq({k: c["g"][k] - r["g"][k] for k in r["g"]}) / gsq(r["g"])
    g_sens = gsq({k: g_moved[k] - r["g"][k] for k in r["g"]}) / gsq(r["g"])
    checks = [
        ("inner gradient ||g_card - g_cpu|| / ||g_cpu||", g_err, 10 * g_sens,
         f"10 x the CPU's own change, {g_sens:.3e}, when the frames move by 1e-6 relative: "
         "fp32 noise flips ReLU masks near zero, and the backbone gradient follows"),
        ("detect on the same fast weights, pred_logits max_abs_err",
         (c["same"] - r["same"]).abs().max().item(), 1e-3 * r["same"].abs().max().item(),
         "1e-3 x max|CPU|: cuDNN vs CPU conv sums, kernel vs plain attention"),
    ]
    for key in ("pred_logits", "pred_boxes"):
        effect = (r[key][0, 0] - r["before"][key]).abs().max().item()
        checks.append((f"predict {key} max_abs_err", (c[key] - r[key]).abs().max().item(),
                       0.1 * effect, f"0.1 x the adaptation's own effect on {key} on the CPU, "
                       f"{effect:.3e}: fp32 noise in g moves the fast weights"))
    log(f"  fp32 inner gradient norm: card {gsq(c['g']):.6e} CPU {gsq(r['g']):.6e}")
    for name, err, tol, why in checks:
        log(f"  fp32 card vs CPU: {name}={err:.3e} tol={tol:.3e} ({why})")
        if not err <= tol:
            raise AssertionError(f"full-width {name}: {err} > {tol}")


def _formulated(counts, split):
    """Launch counts of the merged formulation -> those of `split`'s: each
    merged backward becomes flash_dq + flash_dkv, each merged second-order
    launch flash_so_row + flash_so_col."""
    out = {"flash_fwd": counts["flash_fwd"], "flash_bwd": 0, "flash_dq": 0, "flash_dkv": 0,
           "flash_so": 0, "flash_so_row": 0, "flash_so_col": 0,
           "dropout_mask": counts["dropout_mask"]}
    if split:
        out.update(flash_dq=counts["flash_bwd"], flash_dkv=counts["flash_bwd"],
                   flash_so_row=counts["flash_so"], flash_so_col=counts["flash_so"])
    else:
        out.update(flash_bwd=counts["flash_bwd"], flash_so=counts["flash_so"])
    return out


def expected_launches(C, split=False):
    """Kernel launches of one episode of next_action at s=1..4 + predict, read
    from the gates of ops/attention.py (hd>=32, s>=256, t>=128)."""
    enc = 6  # DETR encoder layers: t=s=361
    fwd = 0
    for s in range(1, C.NUM_FRAMES):
        # 3 full fusion blocks, and the last (pruned to s*50+5 queries) from s=3
        fwd += enc + 3 + (1 if s * C.NUM_QUERIES + C.NUM_FRAMES >= 128 else 0)
    fwd += enc + 4 + enc  # predict: inner forward, then the frame-0 detect
    return _formulated({"flash_fwd": fwd, "flash_bwd": enc + 4, "flash_so": 0,
                        "dropout_mask": 0}, split)


def served_path(model, fa, C, episodes=EPISODES, split=False, chunk=1):
    """Phase 5 (and 10): the interactive evaluator's order, in the merged or
    the split formulation, over `episodes` seeded episodes in lockstep chunks
    of `chunk` (1: one at a time): per chunk next_action at s=1..4 and then
    predict, each one batched call. Returns the launch counts and, per chunk,
    the next_action ms, the predict ms and the whole chunk's ms."""
    fa.reset_launches()
    na_ms, pr_ms, chunk_ms = [], [], []
    nc = model.config.MODEL.NUM_CLASSES + 1
    for start in range(0, episodes, chunk):
        frames = np.concatenate([synthetic_frames(100 + e) for e in range(start, start + chunk)])
        torch.cuda.synchronize()
        t_chunk = time.perf_counter()
        for s in range(1, C.NUM_FRAMES):
            t0 = time.perf_counter()
            a = model.next_action({"frames": frames[:, :s]}).tolist()
            na_ms.append(1e3 * (time.perf_counter() - t0))
            if len(a) != chunk or not all(0 <= x < C.NUM_ACTIONS for x in a):
                raise AssertionError(f"actions {a}: not {chunk} in range")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = model.predict({"frames": frames})
        torch.cuda.synchronize()
        pr_ms.append(1e3 * (time.perf_counter() - t0))
        chunk_ms.append(1e3 * (time.perf_counter() - t_chunk))
        want = {"pred_logits": (chunk, 1, C.NUM_QUERIES, nc),
                "pred_boxes": (chunk, 1, C.NUM_QUERIES, 4)}
        for key, shape in want.items():
            if tuple(pred[key].shape) != shape or not torch.isfinite(pred[key]).all():
                raise AssertionError(f"{key}: shape {tuple(pred[key].shape)} or non-finite")
    counts = dict(fa.launches)
    want = {k: n * (episodes // chunk) for k, n in expected_launches(C, split).items()}
    log(f"  launches on the served path ({episodes} episodes in chunks of {chunk}): {counts} "
        f"(expected {want}: {episodes // chunk} x one chunk's, which is one episode's)")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return counts, na_ms, pr_ms, chunk_ms


def _subtree(e):
    yield e
    for c in e.cpu_children:
        yield from _subtree(c)


def fast_weight_conv_events(events):
    """The profiler events of the fast weights' convolutions, whatever their
    formulation: every op inside a "fast_weight_conv" range (`profile_run`
    opens one around each trainable k>1 `Conv2d` forward), and every
    backward node those ops created, at any order of differentiation: an
    autograd node's evaluation carries the (thread, sequence number) of the
    op that made it, and the ops inside it make the nodes of the next
    order. One chronological pass finds them all."""
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
def fast_weight_conv_ranges():
    """Open a "fast_weight_conv" profiler range around each trainable k>1
    Conv2d forward (the fast weights' convolutions, in the inner and the
    fast-weight passes alike), for `fast_weight_conv_events`."""
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


def profile_run(fn, warm=True, quiet=False):
    """Device time by kernel over one call of `fn` (after a warm-up call
    unless `warm` is False), and the device's idle share (1 - summed kernel
    time / wall time; overlapping kernels would count twice, and these
    paths launch on one stream). Returns {"wall_ms", "device_ms",
    "launches", "conv_ms", "conv_launches"}: conv is the fast weights'
    convolutions in every formulation, forward and backward
    (`fast_weight_conv_events`). With `quiet`, logs the summary line only."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with fast_weight_conv_ranges(), profile(activities=[ProfilerActivity.CPU,
                                                        ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    # the device's spans of the "fast_weight_conv" ranges are annotations,
    # not kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy = sum(t for _, t in by_name.values())
    conv = [k for e in fast_weight_conv_events(events) for k in (e.kernels or [])
            if k.name != "fast_weight_conv"]
    out = {"wall_ms": wall_ms, "device_ms": busy, "launches": len(kernels),
           "conv_ms": sum(k.duration for k in conv) / 1e3, "conv_launches": len(conv)}
    log(f"  wall {wall_ms:.2f} ms, device kernels {busy:.2f} ms in {len(kernels)} launches, "
        f"idle share {1 - busy / wall_ms:.3f} (profiler on); fast-weight convolutions (every "
        f"trainable k>1 conv, forward and backward, in its formulation) {out['conv_ms']:.2f} ms "
        f"in {out['conv_launches']} launches")
    if quiet:
        return out
    # substring matches; no kernel name contains another's
    groups = {"flash_fwd (fwd_kernel, fwd_wgmma_kernel)": ("fwd_kernel", "fwd_wgmma_kernel"),
              "flash_bwd (bwd_kernel, bwd_wgmma_kernel)": ("bwd_kernel", "bwd_wgmma_kernel"),
              "flash_dq (dq_kernel, dq_wgmma_kernel)": ("dq_kernel", "dq_wgmma_kernel"),
              "flash_dkv (dkv_kernel, dkv_wgmma_kernel)": ("dkv_kernel", "dkv_wgmma_kernel"),
              "flash_so (so_kernel, so_wgmma_kernel)": ("so_kernel", "so_wgmma_kernel"),
              "flash_so_row (sov_row_kernel, so_row_wgmma_kernel)": ("sov_row_kernel",
                                                                     "so_row_wgmma_kernel"),
              "flash_so_col (sov_col_kernel, so_col_wgmma_kernel)": ("sov_col_kernel",
                                                                     "so_col_wgmma_kernel"),
              "dropout_mask (mask_vec16_kernel)": ("mask_vec16_kernel",),
              "convolution (cuDNN and friends)": ("conv", "cudnn", "implicit", "xmma", "sm90_",
                                                  "wgrad", "dgrad", "fprop")}
    for gname, keys in groups.items():
        hits = [v for n, v in by_name.items() if any(k in n.lower() for k in keys)]
        log(f"  {gname}: {sum(v[1] for v in hits):.2f} ms in {sum(v[0] for v in hits)} launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"  {t:8.3f} ms {n:5d}x {name[:110]}")
    return out


def synthetic_batch(seed, episodes, num_classes, C, size=300):
    """A batch of `episodes` seeded episodes in the train step's layout:
    frames (b, 5, size, size, 3), 1-10 valid boxes per frame of C.MAX_BOXES."""
    rng = np.random.RandomState(seed)
    shape = (episodes, C.NUM_FRAMES, C.MAX_BOXES)
    valid = np.arange(C.MAX_BOXES) < rng.randint(1, 11, shape[:2])[..., None]
    boxes = np.concatenate([rng.uniform(0.2, 0.8, shape + (2,)),
                            rng.uniform(0.05, 0.4, shape + (2,))], -1)
    return {
        "frames": np.concatenate([synthetic_frames(seed * 100 + e, size=size)
                                  for e in range(episodes)]),
        "actions": rng.randint(0, C.NUM_ACTIONS, shape[:2]).astype(np.int64),
        "labels": (rng.randint(0, num_classes, shape) * valid).astype(np.int64),
        "boxes": (boxes * valid[..., None]).astype(np.float32),
        "valid": valid,
        "episode_uid": np.arange(episodes, dtype=np.int64),
    }


def perturbed(batch, seed=2):
    """`batch` with its frames moved by 1e-6 relative, seeded noise: the
    change against which the fp32 checks measure a problem's sensitivity."""
    noise = np.random.RandomState(seed).randn(*batch["frames"].shape).astype(np.float32)
    return dict(batch, frames=batch["frames"] * (1 + 1e-6 * noise))


def second_order_probe(model, frames):
    """d(sum(w * g)) / d(fusion params) for a fixed seeded w, where g is the
    inner gradient taken with create_graph=True under flash_disabled(): the
    second-order term of the train step alone, without the clipped step,
    the matching or the fast-weight passes, whose discrete decisions make
    the full step's gradient jump under fp32 noise."""
    from interactron_tpu_torch.meta import learned_loss_value, merge_inner, split_inner
    from interactron_tpu_torch.ops.attention import flash_disabled

    with torch.no_grad():
        prefix = model.frozen_prefix(model.frames({"frames": frames})[0])
    adapted, static = split_inner(dict(model.detector.named_parameters()))
    leaves = {k: v.detach().requires_grad_(True) for k, v in adapted.items()}
    fus = {n: p.detach().requires_grad_(True) for n, p in model.fusion.named_parameters()}
    gen = torch.Generator().manual_seed(5)
    w = [torch.randn(v.shape, generator=gen).to(v.device) for v in leaves.values()]
    with flash_disabled():
        out = model.detr_apply(merge_inner(leaves, static), prefix, stage="from_prefix")
        loss = learned_loss_value(model.fusion_apply(out, fus))
    g = torch.autograd.grad(loss, list(leaves.values()), create_graph=True)
    probe = sum((gi * wi).sum() for gi, wi in zip(g, w))
    d = torch.autograd.grad(probe, list(fus.values()), allow_unused=True, materialize_grads=True)
    return dict(zip(fus, (x.cpu() for x in d)))


# the floor of a train step's relative gradient error card vs CPU: fp32
# summation order (cuBLAS/cuDNN vs the CPU) alone moves a gradient by ~1e-5
# relative, above 10x the sensitivity of a well-conditioned model (the ViT
# family: 5e-7 for a 1e-6 relative change of the frames)
GRAD_FLOOR = 1e-4
BATCHED = 2  # episodes of phases 4b and 7b (TRAINER.INNER_BATCH 2)
# noise seeds of the CPU's 1e-6 relative changes of the frames, against
# which the card-vs-CPU train checks (phases 7, 7b, 12a) measure a problem's
# sensitivity: a gradient takes the first (its norm of change sums over all
# its entries), a loss the largest change over all four (a loss is one
# number, and one change of it can be near zero by chance where the
# matching or a ReLU's side jumps). The card never sets its own tolerance.
SENS_SEEDS = (2, 3, 4, 5)


def train_parity(config_dict, Task, Config, weights, C, probe=True):
    """Phase 7 (and 12): one fp32 episode of the train step with dropout on,
    the card against the CPU. The keep bits are a hash of seeds drawn from one
    CPU generator, so both devices drop the same elements. As in phase 4,
    the gradients are held against the CPU's own change when the frames move
    by 1e-6 relative, and so are the losses, which go through the fast
    weights, each over SENS_SEEDS (PERF.md §6). The count-like metrics are
    printed. The full step's
    gradient is discontinuous at that scale (clip boundaries, matching,
    ReLU masks), so with `probe` the second-order term is also held alone
    (`second_order_probe`). Every gradient group the task has is held, to
    no less than GRAD_FLOOR."""
    cfg = json.loads(json.dumps(config_dict))
    cfg["MODEL"]["DTYPE"] = "float32"
    batch = synthetic_batch(7, 1, cfg["MODEL"]["NUM_CLASSES"], C,
                            int(cfg["MODEL"].get("TEST_RESOLUTION", 300)))
    res, first = {}, f"moved{SENS_SEEDS[0]}"
    for dev in ("cpu", "cuda"):
        model = Task(Config(cfg), device=dev).load_weights(weights)
        runs = [("base", batch)] + ([(f"moved{s}", perturbed(batch, s)) for s in SENS_SEEDS]
                                    if dev == "cpu" else [])
        for key, b in runs:
            if probe and key in ("base", first):
                res[(dev, key, "probe")] = second_order_probe(model, b["frames"][0:1])
            t0 = time.perf_counter()
            g, m, _ = model.grads_and_metrics(b, torch.Generator().manual_seed(11),
                                              model.init_path_state(4), train=True,
                                              frame_index=[2])
            if dev == "cuda":
                torch.cuda.synchronize()
            log(f"  {dev} {key}: {time.perf_counter() - t0:.1f} s")
            res[(dev, key)] = ({grp: {n: x.cpu() for n, x in d.items()} for grp, d in g.items()},
                               {k: float(v) for k, v in m.items()})
        del model
    (gc, mc), (gr, mr), gm = res[("cuda", "base")], res[("cpu", "base")], res[("cpu", first)][0]
    norm = lambda d: sum(torch.sum(x.double() ** 2) for x in d.values()).sqrt().item()
    held = [(f"{grp} gradient", gc[grp], gr[grp], gm[grp]) for grp in gr]
    if probe:
        held.append(("second-order probe (fusion)", *(res[(dev, key, "probe")] for dev, key in (
            ("cuda", "base"), ("cpu", "base"), ("cpu", first)))))
    for label, c, r, mv in held:
        err = norm({n: c[n] - r[n] for n in r}) / norm(r)
        sens = norm({n: mv[n] - r[n] for n in r}) / norm(r)
        tol = max(10 * sens, GRAD_FLOOR)
        log(f"  fp32 train step card vs CPU: {label} ||card - cpu|| / ||cpu|| = {err:.3e} "
            f"tol={tol:.3e} (max of 10 x the CPU's own change, {sens:.3e}, when the frames "
            f"move by 1e-6 relative, and {GRAD_FLOOR:g}); norms card {norm(c):.6e} CPU "
            f"{norm(r):.6e}")
        if not err <= tol:
            raise AssertionError(f"train step {label}: {err} > {tol}")
    for k in mr:
        changes = [abs(res[("cpu", f"moved{s}")][1][k] - mr[k]) for s in SENS_SEEDS]
        err, sens = abs(mc[k] - mr[k]), max(changes)
        tol = max(1e-4 * abs(mr[k]), 10 * sens)
        held = "loss" in k or k == "policy_reward"
        log(f"  fp32 train step metric {k}: card {mc[k]:.6f} CPU {mr[k]:.6f} err={err:.3e} "
            + (f"tol={tol:.3e} (max of 1e-4 x |CPU| and 10 x the CPU's largest own change, "
               f"{sens:.3e}, of {', '.join(f'{c:.3e}' for c in changes)})" if held
               else "(count-like, printed only)"))
        if held and not err <= tol:
            raise AssertionError(f"train step metric {k}: {err} > {tol}")


def batched_parity(cfg, Task, Config, weights, C, what):
    """Phases 4b and 7b: episode batching in fp32 at PARITY_DEPTH with
    dropout off, on `weights` (calibrated at that depth). `what` is
    "predict" (one predict of BATCHED episodes in one call) or "train" (a
    train step of BATCHED episodes at TRAINER.INNER_BATCH BATCHED, one
    microbatch, frame indices fixed). Each is held (a) on the card against
    the same episodes one at a time (INNER_BATCH 1) and (b) against the
    CPU's batched call. Predictions are held to 0.1 x the adaptation's own
    effect (phase 4's rule); gradients to 10 x the reference's own change
    when the frames move by 1e-6 relative, no less than GRAD_FLOOR, and
    losses to the larger of 1e-4 relative and 10 x that change (phase 7's
    rule): against the card one at a time, the card's batched change; against
    the CPU, the CPU's over SENS_SEEDS."""
    n = BATCHED
    batch = synthetic_batch(7, n, cfg["MODEL"]["NUM_CLASSES"], C,
                            int(cfg["MODEL"].get("TEST_RESOLUTION", 300)))
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}

    def run(dev, inner_batch, b):
        c = json.loads(json.dumps(cfg))
        c["TRAINER"]["INNER_BATCH"] = inner_batch
        model = Task(Config(c), device=dev).load_weights(weights)
        t0 = time.perf_counter()
        if what == "predict":
            parts = ([{"frames": b["frames"]}] if inner_batch > 1 else
                     [{"frames": b["frames"][i:i + 1]} for i in range(n)])
            preds = [model.predict(p) for p in parts]
            out = {"pred": {k: torch.cat([p[k] for p in preds]).cpu() for k in preds[0]}}
            with torch.no_grad():
                before = model.detr_apply(None, model.frames(b)[:, 0])
            out["before"] = {k: before[k][:, None].cpu() for k in out["pred"]}
        else:
            grads, m, _ = model.grads_and_metrics(b, None, model.init_path_state(8), train=False,
                                                  frame_index=[2, 3][:n])
            out = {"grads": {grp: cpu(d) for grp, d in grads.items()},
                   "m": {k: float(v) for k, v in m.items()}}
        if dev == "cuda":
            torch.cuda.synchronize()
        log(f"  ({what}) {dev} INNER_BATCH {inner_batch}: {time.perf_counter() - t0:.1f} s")
        return out

    ref = run("cuda", n, batch)
    cpu_ref = run("cpu", n, batch)
    for label, other, base, moved in (
            ("card batched vs card one at a time", run("cuda", 1, batch), ref,
             what == "train" and [run("cuda", n, perturbed(batch))]),
            ("card batched vs CPU batched", cpu_ref, cpu_ref,
             what == "train" and [run("cpu", n, perturbed(batch, s)) for s in SENS_SEEDS])):
        if what == "predict":
            hold_predict(f"fp32 {label}: predict of {n} episodes", ref, other)
        else:
            hold_train(f"fp32 {label}: train step of {n} episodes", ref, other, base, moved,
                       "card's" if base is ref else "CPU's")


def hold_predict(label, got, ref):
    """Phase 4's rule: predictions to 0.1 x the adaptation's own effect
    (`ref`'s predict against its unadapted detect, "before")."""
    for key in ("pred_logits", "pred_boxes"):
        effect = (ref["pred"][key] - ref["before"][key]).abs().max().item()
        err = (got["pred"][key] - ref["pred"][key]).abs().max().item()
        log(f"  {label} {key} max_abs_err={err:.3e} tol={0.1 * effect:.3e} (0.1 x the "
            f"adaptation's own effect, {effect:.3e})")
        if not err <= 0.1 * effect:
            raise AssertionError(f"{label} {key}: {err} > {0.1 * effect}")


def _norm(d):
    return sum(torch.sum(x.double() ** 2) for x in d.values()).sqrt().item()


def hold_train(label, got, ref, base, moved, whose):
    """Phase 7's rule: each gradient group to 10 x `base`'s own change when
    the frames move by 1e-6 relative (`moved`, a list of such runs; the
    first sets a gradient's), no less than GRAD_FLOOR; losses to the larger
    of 1e-4 relative and 10 x the largest change over `moved`."""
    for grp in got["grads"]:
        r, o, b, mv = (got["grads"][grp], ref["grads"][grp], base["grads"][grp],
                       moved[0]["grads"][grp])
        err = _norm({k: r[k] - o[k] for k in r}) / _norm(o)
        sens = _norm({k: mv[k] - b[k] for k in b}) / _norm(b)
        tol = max(10 * sens, GRAD_FLOOR)
        log(f"  {label}, {grp} gradient ||a - b|| / ||b|| = {err:.3e} tol={tol:.3e} (max of 10 x "
            f"the {whose} own change, {sens:.3e}, and {GRAD_FLOOR:g})")
        if not err <= tol:
            raise AssertionError(f"{label} {grp}: {err} > {tol}")
    for k, v in ref["m"].items():
        if "loss" in k or k == "policy_reward":
            changes = [abs(mv["m"][k] - base["m"][k]) for mv in moved]
            err, sens = abs(got["m"][k] - v), max(changes)
            tol = max(1e-4 * abs(v), 10 * sens)
            log(f"  {label}: metric {k} {got['m'][k]:.6f} vs {v:.6f} err={err:.3e} "
                f"tol={tol:.3e} (max of 1e-4 x |b| and 10 x the {whose} largest own "
                f"change, of {', '.join(f'{c:.3e}' for c in changes)})")
            if not err <= tol:
                raise AssertionError(f"{label} metric {k}: {err} > {tol}")


def _depths(m):
    """(DETR encoder layers, decoder layers, fusion layers, ViT layers (0
    without the ViT backbone), whether the fusion is FusionXAttn)."""
    return (int(m.get("NUM_ENCODER_LAYERS", 6)), int(m.get("NUM_DECODER_LAYERS", 6)),
            int(m.NUM_LAYERS), 12 if m.get("BACKBONE") in ("vit_b16", "vit") else 0,
            m.TYPE == "interactron_random")


def expected_train_launches(m, split=False, microbatches=1):
    """Kernel launches of one train step of `microbatches` microbatches of
    TRAINER.INNER_BATCH episodes (`detr`: of the step's one pass), read from
    the gates of ops/attention.py (hd>=32, s>=256, t>=128). A microbatch is
    one batched pass over its episodes, so its launches do not depend on how
    many it holds. The backbone's and the DETR encoder's attentions (the ViT's 12 at t=s=361, the
    encoder's 6) pass the gates; the decoder's 50 queries stay dense. A
    fusion layer has one attention past the gates: FusionGPT's block (its
    dropout fused), FusionXAttn's cross-attention (255 queries over 1805
    keys; its 255-token self-attention stays dense and draws a mask).
      * interactron, interactron_random: the inner closure's attentions
        past the second-order gates take FlashAttentionSO: its forward, the
        g pass's FlashGrads forward (forward recompute + backward), and in
        the outer backward its own backward again (FlashGrads forward) and
        FlashGrads' backward (forward recompute + second-order kernel); the
        ViT's attentions skip that repeat of their own backward: every
        weight upstream of them is adapted, so stopped before the inner
        closure, and the outer gradient has nowhere to go through their
        forward (the DETR encoder's lead back to the unadapted q/k/v). The
        supervisor and detector passes take the first-order kernels in the
        backbone and encoder. Mask sites (dropouts outside the fused
        kernels): per DETR pass 3 an encoder layer, 4 + 2 attention masks a
        decoder layer; per fusion pass FusionGPT's embedding's and 2 a
        block, or FusionXAttn's 4 + 1 a layer. A site launches the mask
        once in its forward; under MODEL.REMAT_DROPOUT (the default) once
        more in each backward that runs through it: the supervisor's and
        the detector's DETR passes once (x2), the inner DETR and fusion
        passes three times (x4): the inner gradient's backward, the outer
        backward through that backward's own mask applications, and the
        outer backward through the forward (every site lies between the
        unadapted q/k/v or the fusion's weights and the loss).
      * detr_multiframe: per microbatch one detector pass (encoder without
        dropout, decoder with it), one fusion pass, their first-order
        backward (x2 under MODEL.REMAT_DROPOUT).
      * detr: the step's b*s frames in one detector pass and its backward,
        whatever `microbatches` is (x2 under MODEL.REMAT_DROPOUT).
    The ViT's dropout rate is 0: it draws no mask. tests/
    test_torch_port_formulations.py counts the mask calls of one step on
    the CPU, at sizes that route each attention as here, against this."""
    enc, dec, layers, vit, xattn = _depths(m)
    first = vit + enc
    fusion_masks = 5 * layers if xattn else 1 + 2 * layers
    detr_masks = 3 * enc + 6 * dec
    # launches of a mask site in a pass differentiated once, and in the inner passes
    once, inner_x = (2, 4) if bool(m.get("REMAT_DROPOUT", True)) else (1, 1)
    if m.TYPE == "detr":
        return _formulated({"flash_fwd": first, "flash_bwd": first, "flash_so": 0,
                            "dropout_mask": once * detr_masks}, split)
    if m.TYPE == "detr_multiframe":
        per = {"flash_fwd": first + layers, "flash_bwd": first + layers, "flash_so": 0,
               "dropout_mask": once * (6 * dec + fusion_masks)}
    else:
        inner = first + layers
        per = {"flash_fwd": 4 * inner + 2 * first - vit,
               "flash_bwd": 2 * inner + 2 * first - vit,
               "flash_so": inner,
               # the inner passes' sites, then the supervisor's and the detector's
               "dropout_mask": inner_x * (detr_masks + fusion_masks) + 2 * once * detr_masks}
    return _formulated({k: v * microbatches for k, v in per.items()}, split)


def expected_predict_launches(m):
    """Kernel launches of one predict of any number of episodes (one batched
    pass): the adaptive tasks' inner forward and first-order backward, then
    the frame-0 detect; the baselines' one forward of the detector (and the
    fusion)."""
    enc, _, layers, vit, _ = _depths(m)
    first = vit + enc
    if m.TYPE == "detr":
        counts = {"flash_fwd": first, "flash_bwd": 0}
    elif m.TYPE == "detr_multiframe":
        counts = {"flash_fwd": first + layers, "flash_bwd": 0}
    else:
        counts = {"flash_fwd": 2 * first + layers, "flash_bwd": first + layers}
    return _formulated({**counts, "flash_so": 0, "dropout_mask": 0}, False)


def expected_episode_launches(m, evaluator, num_queries, num_frames):
    """Kernel launches of one evaluated episode, or under the interactive
    evaluator of one lockstep chunk: predict, after four next_action calls
    at s = 1..4 under the interactive evaluator (the fusion's last block
    passes the gates from s*50 + 5 >= 128 queries)."""
    counts = expected_predict_launches(m)
    if evaluator == "interactive_evaluator":
        enc, _, layers, vit, _ = _depths(m)
        counts["flash_fwd"] += sum(vit + enc + layers - 1 + (s * num_queries + num_frames >= 128)
                                   for s in range(1, num_frames))
    return counts


def train_bf16(model, fa, C, Trainer, steps=3, episodes=4, split=False):
    """Phase 8 (and 10): `steps` optimizer steps of `episodes` episodes in
    bf16 with dropout on, in the merged or the split formulation, at the
    config's TRAINER.INNER_BATCH; then one step at INNER_BATCH 1, the
    serial path. Each with its launch counts. Returns (launch counts of the
    batched steps, ms per batched step, the trainer, the profile batch,
    the serial step's ms)."""
    cfg = model.config
    trainer = Trainer(model, cfg, path_rows=64)
    gen = torch.Generator().manual_seed(0)
    batches = [synthetic_batch(20 + i, episodes, cfg.MODEL.NUM_CLASSES, C)
               for i in range(steps + 1)]
    before = {grp: [p.detach().clone() for p in mod.parameters()]
              for grp, mod in (("detector", model.detector), ("fusion", model.fusion))}
    inner = model.inner_batch

    def step(i, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in trainer.train_step(batch, gen).items()}
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        log(f"  step {i} (INNER_BATCH {model.inner_batch}): {ms:.1f} ms, total_loss "
            f"{metrics['total_loss']:.4f}, grad_norm {metrics['grad_norm']:.4e}, "
            f"policy_reward {metrics['policy_reward']:.4f}")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite metrics at step {i}: {metrics}")
        return ms

    fa.reset_launches()
    step_ms = [step(i, batch) for i, batch in enumerate(batches[:steps])]
    counts = dict(fa.launches)
    micro = len(model.microbatches(episodes))
    want = {k: n * steps for k, n in expected_train_launches(cfg.MODEL, split, micro).items()}
    log(f"  launches of the {steps} steps at INNER_BATCH {inner} ({micro} microbatch(es) of "
        f"{episodes // micro} a step): {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"train launch counts {counts} != {want}")
    model.inner_batch = 1
    try:
        fa.reset_launches()
        serial_ms = step(steps, batches[steps])
        serial = dict(fa.launches)
    finally:
        model.inner_batch = inner
    want = expected_train_launches(cfg.MODEL, split, episodes)
    log(f"  launches of one step at INNER_BATCH 1 ({episodes} microbatches of 1): {serial} "
        f"(expected {want})")
    if serial != want:
        raise AssertionError(f"serial train launch counts {serial} != {want}")
    for grp, mod in (("detector", model.detector), ("fusion", model.fusion)):
        moved = sum(int(not torch.equal(p, q)) for p, q in zip(mod.parameters(), before[grp]))
        log(f"  {grp}: {moved} of {len(before[grp])} parameter tensors moved")
        if moved == 0:
            raise AssertionError(f"no {grp} parameter moved")
    return counts, step_ms, trainer, batches[0], serial_ms


SPLIT = {"FLASH_BWD": "split", "SO_MERGED": "0"}


@contextlib.contextmanager
def switches(**env):
    """Set the backward-formulation switches in os.environ (the port reads
    them at each call) and restore them afterwards."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def split_parity(config_dict, Task, Config, weights, C, fa):
    """Phase 10a: fp32 on the card, the split formulation against the merged
    one on the same weights and episode: predict's inner gradient g, the
    second-order probe, and one episode of the train step with dropout on
    (both formulations draw the same masks). As in phases 4 and 7, each is
    held against 10x the merged run's own change when the frames move by
    1e-6 relative; the losses also to 1e-4 relative."""
    cfg = json.loads(json.dumps(config_dict))
    cfg["MODEL"]["DTYPE"] = "float32"
    batch = synthetic_batch(7, 1, cfg["MODEL"]["NUM_CLASSES"], C)
    model = Task(Config(cfg), device="cuda").load_weights(weights)
    cpu = lambda d: {n: x.cpu() for n, x in d.items()}

    def run(b):
        _, g, _ = model.adapt({"frames": b["frames"]})
        probe = second_order_probe(model, b["frames"][0:1])
        grads, m, _ = model.grads_and_metrics(b, torch.Generator().manual_seed(11),
                                              model.init_path_state(4), train=True,
                                              frame_index=[2])
        return ({"inner gradient g": cpu(g), "second-order probe (fusion)": probe,
                 "train step detector gradient": cpu(grads["detector"]),
                 "train step fusion gradient": cpu(grads["fusion"])},
                {k: float(v) for k, v in m.items()})

    fa_launches = {}
    res = {}
    for key, b, env in (("merged", batch, {}), ("moved", perturbed(batch), {}),
                        ("split", batch, SPLIT)):
        fa.reset_launches()
        t0 = time.perf_counter()
        with switches(**env):
            res[key] = run(b)
        torch.cuda.synchronize()
        fa_launches[key] = {k: n for k, n in fa.launches.items() if n}
        log(f"  {key}: {time.perf_counter() - t0:.1f} s, launches {fa_launches[key]}")
    if fa_launches["split"].get("flash_bwd") or fa_launches["split"].get("flash_so"):
        raise AssertionError(f"split run launched merged kernels: {fa_launches['split']}")
    norm = lambda d: sum(torch.sum(x.double() ** 2) for x in d.values()).sqrt().item()
    (gm, mm), (gv, mv), (gs, ms) = res["merged"], res["moved"], res["split"]
    for label in gm:
        err = norm({n: gs[label][n] - gm[label][n] for n in gm[label]}) / norm(gm[label])
        sens = norm({n: gv[label][n] - gm[label][n] for n in gm[label]}) / norm(gm[label])
        log(f"  fp32 split vs merged: {label} ||split - merged|| / ||merged|| = {err:.3e} "
            f"tol={10 * sens:.3e} (10 x the merged run's own change, {sens:.3e}, when the "
            f"frames move by 1e-6 relative)")
        if not err <= 10 * sens:
            raise AssertionError(f"split vs merged {label}: {err} > {10 * sens}")
    for k in mm:
        if "loss" in k or k == "policy_reward":
            err, tol = abs(ms[k] - mm[k]), max(1e-4 * abs(mm[k]), 10 * abs(mv[k] - mm[k]))
            log(f"  fp32 split vs merged metric {k}: split {ms[k]:.6f} merged {mm[k]:.6f} "
                f"err={err:.3e} tol={tol:.3e} (max of 1e-4 x |merged| and 10 x its own change)")
            if not err <= tol:
                raise AssertionError(f"split vs merged metric {k}: {err} > {tol}")


DISK_EPISODES, DISK_STATES = 8, 6  # the synthetic JPEG tree of phase 11


def _nested_equal(a, b):
    """torch.equal over nested dicts and lists of tensors; == elsewhere."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.shape == b.shape and torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_nested_equal(a[k], b[k])
                                                                  for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_nested_equal(x, y) for x, y in zip(a, b))
    return a == b


def _train_state(trainer):
    """(weights, Adam states, path state, tokens) of a trainer, copied."""
    return copy.deepcopy((trainer.task.state_dict(),
                          {g: o.state_dict() for g, o in trainer.opts.items()},
                          trainer.path_state, trainer.tokens))


@contextlib.contextmanager
def instrument(obj, name, record):
    """Wrap obj.name: after each call, record(args, seconds, launches) with
    its wall time (between device synchronizes) and the kernel launches it
    made. The wrapper is removed on exit."""
    from interactron_tpu_torch.ops import flash_attention as fa

    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        before = dict(fa.launches)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        record(a, time.perf_counter() - t0,
               {k: v - before.get(k, 0) for k, v in fa.launches.items()})
        return out

    setattr(obj, name, wrapped)
    try:
        yield
    finally:
        delattr(obj, name)


def _finite_records(out_dir):
    """The run's metrics.jsonl records; fails where a value is not finite."""
    with open(os.path.join(out_dir, "logs", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    bad = [(r["step"], k, v) for r in recs for k, v in r.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite logged metrics: {bad}")
    return recs


def make_tree(root, C):
    """The port's synthetic writer's JPEG tree of DISK_EPISODES episodes x
    DISK_STATES states of C.IMG_SIZE px under `root`: (image root,
    annotation file)."""
    from interactron_tpu_torch.data.synthetic import make_synthetic_dataset

    t0 = time.perf_counter()
    tree = make_synthetic_dataset(os.path.join(root, "tree"), DISK_EPISODES, DISK_STATES,
                                  C.IMG_SIZE)
    log(f"  synthetic tree: {DISK_EPISODES} episodes x {DISK_STATES} states of {C.IMG_SIZE} px "
        f"JPEGs in {time.perf_counter() - t0:.1f} s; DATASET.TRAIN and DATASET.TEST both read it")
    return tree


def disk_config(cfg_dict, tree, out, cuts):
    """`cfg_dict` with DATASET on `tree`, outputs under `out`, and `cuts`
    ({(section, key): value}, each logged where it changes the config)."""
    img_root, ann = tree
    d = json.loads(json.dumps(cfg_dict))
    d["DATASET"] = {split: dict(d["DATASET"][split], ANNOTATION_ROOT=ann, IMAGE_ROOT=img_root)
                    for split in ("TRAIN", "TEST")}
    for (sec, key), v in cuts.items():
        if d[sec].get(key) != v:
            log(f"  cut: {sec}.{key} {d[sec].get(key, 'unset')} -> {v}")
            d[sec][key] = v
    d["TRAINER"]["OUTPUT_DIRECTORY"] = os.path.join(out, "train")
    d["EVALUATOR"]["OUTPUT_DIRECTORY"] = os.path.join(out, "eval")
    return d


# the frame-0 predictions phases 11c and 12c hold, lockstep against serial
PRED_KEYS = ("pred_logits", "pred_boxes")


def lockstep_records(d, Task, Config, weights, card):
    """Phases 11c and 12c: the interactive evaluator of the disk config `d`
    in fp32 on the card, in lockstep (the config's ROLLOUT_BATCH: one chunk
    of the tree's episodes) against the serial rollout (ROLLOUT_BATCH 1) on
    the same `weights`. Each episode's frame-0 predictions are held to 0.1 x
    the adaptation's own effect on them (the serial prediction against the
    unadapted detector's on the same frame: phase 4b's rule), and the
    records must agree in order, image, type and category, and TP/FP/FN;
    their scores, IoUs and boxes are printed. A planted fault, the lockstep
    run with each episode's fast weights handed to the next episode of its
    chunk, must break that hold (on the logits or the boxes): else the
    check could not see a wrong pairing of episodes and fast weights."""
    from interactron_tpu_torch.meta import split_inner
    from interactron_tpu_torch.utils.config import build_evaluator

    cfg = json.loads(json.dumps(d))
    cfg["MODEL"]["DTYPE"] = "float32"
    task = Task(Config(cfg), device="cuda").load_weights(weights)
    adapted = set(split_inner(dict(task.detector.named_parameters()))[0])
    adapt = task.adapt

    def misrouted(episodes):
        fast, g, prefix = adapt(episodes)
        return {k: v.roll(1, 0) if k in adapted else v for k, v in fast.items()}, g, prefix

    def evaluate(rb, planted=False):
        c = json.loads(json.dumps(cfg))
        if rb is not None:
            c["EVALUATOR"]["ROLLOUT_BATCH"] = rb
        ev = build_evaluator(task, Config(c))
        recs, preds, score = [], [], ev._score_episode

        def capture(batch, p):
            preds.append((batch, {k: p[k][0, 0].float().cpu() for k in PRED_KEYS}))
            dets = score(batch, p)
            recs.extend(dets)
            return dets

        ev._score_episode = capture
        if planted:
            task.adapt = misrouted
        try:
            t0 = time.perf_counter()
            out = ev.evaluate(save_results=False, trained=True)
            torch.cuda.synchronize()
        finally:
            task.__dict__.pop("adapt", None)
        return recs, preds, out, time.perf_counter() - t0, ev.chunk

    (lock, lock_p, lock_out, lock_s, chunk), (serial, serial_p, serial_out, serial_s, _) = (
        evaluate(None), evaluate(1))
    planted_p = evaluate(None, planted=True)[1]
    with torch.no_grad():
        before = [task.detr_apply(None, task.frames(b)[:, 0]) for b, _ in serial_p]
    effect = {k: max((p[k] - o[k][0].float().cpu()).abs().max().item()
                     for (_, p), o in zip(serial_p, before)) for k in PRED_KEYS}
    diff = lambda ps: {k: max((a[k] - b[k]).abs().max().item()
                              for (_, a), (_, b) in zip(ps, serial_p)) for k in PRED_KEYS}
    sound, planted = diff(lock_p), diff(planted_p)
    same = len(lock) == len(serial) and all(
        a[k] == b[k] for a, b in zip(lock, serial) for k in ("img", "type", "pred_cat"))
    errs = {k: max((float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k]))))
                    for a, b in zip(lock, serial)), default=0.0)
            for k in ("pred_score", "iou", "box")}
    for k in PRED_KEYS:
        log(f"  fp32 lockstep (chunks of {chunk}, {lock_s:.2f} s) vs serial ({serial_s:.2f} s), "
            f"{len(serial_p)} episodes: {k} max_abs_err={sound[k]:.3e} tol={0.1 * effect[k]:.3e} "
            f"(0.1 x the adaptation's own effect, {effect[k]:.3e}); planted fault (each "
            f"episode's fast weights given to the next): {planted[k]:.3e}")
    log(f"  records: {len(lock)} vs {len(serial)}, image, type and category equal: {same}; "
        "max abs diff " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; TP/FP/FN {lock_out[2:]} vs {serial_out[2:]}; card: {card}")
    if not same or lock_out[2:] != serial_out[2:]:
        raise AssertionError(f"lockstep records differ from serial: same {same}, "
                             f"{lock_out[2:]} vs {serial_out[2:]}")
    for k in PRED_KEYS:
        if not sound[k] <= 0.1 * effect[k]:
            raise AssertionError(f"lockstep {k} vs serial: {sound[k]} > {0.1 * effect[k]}")
    if not any(planted[k] > 0.1 * effect[k] for k in PRED_KEYS):
        raise AssertionError(f"the planted wrong pairing passes the hold: {planted} vs 0.1 x "
                             f"{effect}")


def from_scratch_step(cfg_dict, tree, card):
    """Phase 11b's premise, printed: the training entry point's own weights
    (`init(42)`: every FrozenBatchNorm's statistics the identity, and no
    pretrained backbone in the repo) take one bf16 train step on the tree's
    first 4 episodes, at the config's INNER_BATCH and at 1, and the gradient
    leaves that are not finite are counted by group. Where some are not,
    the first optimizer step writes them into the weights, and the next
    step's matching raises (scipy's assignment of a NaN cost), which is why
    11b resumes from phase 11's calibrated state."""
    from interactron_tpu_torch.data.episode_dataset import EpisodeDataset, EpisodeLoader
    from interactron_tpu_torch.tasks import InteractronTask
    from interactron_tpu_torch.utils.config import Config

    batch = None
    for ib in (int(cfg_dict["TRAINER"]["INNER_BATCH"]), 1):
        c = json.loads(json.dumps(cfg_dict))
        c["TRAINER"]["INNER_BATCH"] = ib
        task = InteractronTask(Config(c), device="cuda").init(42)
        if batch is None:  # the test transform, at the trainer's sizes
            ds = EpisodeDataset(*tree, "train", resolution=task.img_size,
                                max_boxes=task.max_boxes)
            batch = next(iter(EpisodeLoader(ds, 4, shuffle=False, num_workers=0)))
        g, m, _ = task.grads_and_metrics(batch, torch.Generator().manual_seed(0),
                                         task.init_path_state(8), train=True)
        bad = {grp: sum(int(not torch.isfinite(x).all()) for x in d.values())
               for grp, d in g.items()}
        log(f"  from the entry point's seed-42 weights, INNER_BATCH {ib}: total_loss "
            f"{float(m['total_loss']):.4f}; gradient leaves not finite {bad} of "
            f"{ {grp: len(d) for grp, d in g.items()} }; card: {card}")
        del task, g


def train_entry_point(cfg_path, tree, card, resume_from, weights=None, env=None):
    """Phase 11b: `python -m interactron_tpu_torch.train --config_file <yaml>
    --device cuda` in a child process on the config at `cfg_path` with only
    DATASET, the epoch and batch cuts, the output directories and
    TRAINER.RESUME_FROM changed: the config's INNER_BATCH and ROLLOUT_BATCH,
    the epoch-0 test epoch and evaluation, one train epoch, a test epoch and
    evaluation. It resumes from `resume_from` (phase 11's state after epoch
    1, its weights calibrated on the tree), because the entry point's own
    seed-42 weights do not train in bf16 (`from_scratch_step`). Its
    metrics.jsonl must hold steps 0 and 1, finite. Phase 13(d) runs it
    without a resume (2 epochs) from MODEL.WEIGHTS `weights`, with torchrun's
    environment `env`. Returns the run directory's name and its files."""
    import yaml

    from interactron_tpu_torch.utils.config import get_config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_entry_") as tmp:
        cuts = {("TRAINER", "BATCH_SIZE"): 4, ("TRAINER", "SAVE_WINDOW"): 1}
        if resume_from:
            cuts.update({("TRAINER", "MAX_EPOCHS"): 3, ("TRAINER", "RESUME_FROM"): resume_from})
        else:
            cuts[("TRAINER", "MAX_EPOCHS")] = 2
        if weights:
            cuts[("MODEL", "WEIGHTS")] = weights
        d = disk_config(get_config(cfg_path).to_dict(), tree, tmp, cuts)
        path = os.path.join(tmp, "config.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
        torch.cuda.empty_cache()
        cmd = [sys.executable, "-m", "interactron_tpu_torch.train", "--config_file", path,
               "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=900,
                              env=dict(os.environ, **(env or {})))
        secs = time.perf_counter() - t0
        for line in proc.stdout.splitlines()[-6:]:
            log(f"    | {line}")
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
            raise AssertionError(f"{' '.join(cmd[1:4])} exited {proc.returncode}")
        (run_dir,) = os.listdir(d["TRAINER"]["OUTPUT_DIRECTORY"])
        files = sorted(os.listdir(os.path.join(d["TRAINER"]["OUTPUT_DIRECTORY"], run_dir)))
        recs = _finite_records(os.path.join(d["TRAINER"]["OUTPUT_DIRECTORY"], run_dir))
        if [r["step"] for r in recs] != [0, 1]:
            raise AssertionError(f"entry point logged steps {[r['step'] for r in recs]}")
        log(f"  {' '.join(cmd[1:4])} {os.path.basename(cfg_path)} --device cuda: exit 0 in "
            f"{secs:.1f} s (process start{' and the resume' if resume_from else ''} included), "
            f"TRAINER.INNER_BATCH "
            f"{d['TRAINER']['INNER_BATCH']}, EVALUATOR.ROLLOUT_BATCH "
            f"{d['EVALUATOR'].get('ROLLOUT_BATCH', 'unset (10)')}; step 1: " + ", ".join(
                f"{k} {recs[1][k]:.5g}" for k in ("Train/total_loss", "Test/total_loss",
                                                  "Test/mAP_50") if k in recs[1])
            + f"; card: {card}")
    return run_dir, files


def train_from_disk(cfg_dict, fa, C, card, tree):
    """Phase 11: the user's path from disk at full width, over `tree`
    (`make_tree`): `build_model`, `build_evaluator` and `build_trainer` run
    `Trainer.train`: the epoch-0
    test epoch and closed-loop evaluation with AP, one train epoch through
    the loader, a test epoch and evaluation, `last_state.ckpt` and
    `detector.ckpt`. Then `detector.ckpt` in a fresh task must predict
    `torch.equal` to the trained task, and a resume from `last_state.ckpt`
    must restore the whole train state and run one more epoch. The weights
    are seed 0's with FrozenBatchNorm statistics calibrated on the tree's
    own frames: with phase 4's, calibrated on noise, the first train step on
    these flat images overflows bf16 (the fast-weight detector pass's DETR
    encoder attention gets inputs so large that its backward gives NaN, the
    plain version's on the same inputs too). Returns the launch counts of
    the first run."""
    from interactron_tpu_torch.data.episode_dataset import EpisodeDataset, EpisodeLoader
    from interactron_tpu_torch.tasks import InteractronTask
    from interactron_tpu_torch.utils import checkpoint as ckpt
    from interactron_tpu_torch.utils.config import (
        Config,
        build_evaluator,
        build_model,
        build_trainer,
    )

    img_root, ann = tree
    with tempfile.TemporaryDirectory(prefix="chip_smoke_disk_") as tmp:
        d = disk_config(cfg_dict, tree, tmp, {
            ("TRAINER", "BATCH_SIZE"): 4, ("TRAINER", "MAX_EPOCHS"): 2,
            ("TRAINER", "SAVE_WINDOW"): 1, ("EVALUATOR", "TYPE"): "interactive_evaluator"})
        cfg = Config(d)
        workers = int(d["TRAINER"]["NUM_WORKERS"])
        calib = EpisodeDataset(img_root, ann, "test")
        weights = calibrated_weights(cfg_dict, InteractronTask, Config, np.concatenate(
            [calib.get_item(i)["frames"] for i in (0, 3)]))
        log("  weights: seed 0, FrozenBatchNorm statistics calibrated on the 10 frames of "
            "episodes 0 and 3 of the tree")

        # the loader alone: train transform, the config's threads
        ds = EpisodeDataset(img_root, ann, "train", train_aug=True)
        t0 = time.perf_counter()
        n = sum(len(b["episode_uid"]) for e in range(3)
                for b in EpisodeLoader(ds, 4, shuffle=True, num_workers=workers, seed=e))
        loader_eps = n / (time.perf_counter() - t0)
        log(f"  loader alone: {loader_eps:.3f} episodes/s ({n} episodes, train transform, "
            f"{workers} threads); card: {card}")

        task = build_model(cfg, device="cuda").load_weights(weights)
        evaluator = build_evaluator(task, cfg)
        trainer = build_trainer(task, cfg, evaluator=evaluator)
        steps, epochs, evals, scores = [], {"train": [], "test": []}, [], []
        step_launches = {}

        def on_step(args, secs, launched):
            steps.append(secs)
            for k, v in launched.items():
                step_launches[k] = step_launches.get(k, 0) + v

        with instrument(trainer, "train_step", on_step), \
                instrument(trainer, "_run_epoch", lambda a, t, _: epochs[a[0]].append(t)), \
                instrument(evaluator, "evaluate", lambda a, t, _: evals.append(t)), \
                instrument(evaluator, "_score_episode", lambda a, t, _: scores.append(t)):
            fa.reset_launches()
            t0 = time.perf_counter()
            trainer.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(fa.launches)
        log(f"  Trainer.train, 2 epochs: {wall:.1f} s; launches {counts}")
        recs = _finite_records(trainer.out_dir)
        for r in recs:
            log(f"  metrics.jsonl step {r['step']}: " + ", ".join(
                f"{k} {v:.5g}" for k, v in r.items() if k not in ("step", "time")))
        n_train = len(steps) * 4
        micro = len(task.microbatches(4))
        want = {k: v * len(steps)
                for k, v in expected_train_launches(cfg.MODEL, microbatches=micro).items()}
        log(f"  launches of the {len(steps)} train steps: {step_launches} (expected {want}: "
            f"phase 8's count a microbatch x {micro} microbatch(es) of INNER_BATCH "
            f"{task.inner_batch} a step)")
        if any(step_launches.get(k, 0) != want.get(k, 0) for k in {*step_launches, *want}):
            raise AssertionError(f"train-loop launches {step_launches} != {want}")
        (train_s,) = epochs["train"]
        log(f"  train epoch from disk: {n_train / train_s:.3f} episodes/s ({n_train} episodes in "
            f"{train_s:.2f} s); the step's share of the epoch's wall {sum(steps) / train_s:.3f} "
            f"(steps {', '.join(f'{1e3 * s:.0f}' for s in steps)} ms); card: {card}")
        log(f"  test epochs: {', '.join(f'{s:.2f}' for s in epochs['test'])} s for "
            f"{DISK_EPISODES} episodes each")
        n_eval = len(evaluator.dataset)
        log(f"  evaluation (closed loop in lockstep chunks of {evaluator.chunk}, AP): "
            f"{n_eval / np.mean(evals):.3f} episodes/s "
            f"(mean of {len(evals)} runs of {n_eval} episodes, "
            f"{', '.join(f'{s:.2f}' for s in evals)} s); host scoring "
            f"{1e3 * np.mean(scores):.2f} ms an episode (mean of {len(scores)}), "
            f"{np.sum(scores) / np.sum(evals):.3f} of the evaluation; card: {card}")

        # detector.ckpt in a fresh task: predict torch.equal to the trained task's
        # (the split formulation and cuDNN's deterministic algorithms, so that two
        # runs of one predict are bitwise equal)
        fresh = build_model(cfg, device="cuda").init(3)
        t0 = time.perf_counter()
        names = ckpt.load_checkpoint(trainer.checkpoint_path, fresh)
        load_s = time.perf_counter() - t0
        if set(names) != set(fresh.state_dict()):
            raise AssertionError("detector.ckpt misses weights")
        episode = evaluator.dataset.partial_sample(0, ["MoveAhead"] * (C.NUM_FRAMES - 1))
        cudnn_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with switches(**SPLIT):
                preds = [m.predict(episode) for m in (task, task, fresh)]
        finally:
            torch.backends.cudnn.deterministic = cudnn_det
        same = [all(torch.equal(p[k], preds[0][k]) for k in p) for p in preds[1:]]
        log(f"  detector.ckpt ({os.path.getsize(trainer.checkpoint_path) / 1e6:.1f} MB, loaded "
            f"in {load_s:.2f} s) in a fresh task: predict torch.equal to the trained task's: "
            f"{same[1]} (the trained task twice: {same[0]})")
        if not all(same):
            raise AssertionError(f"predict after detector.ckpt not equal: {same}")
        del fresh

        # the whole train state: its size, a save and a load, and a resume
        last = os.path.join(trainer.out_dir, "last_state.ckpt")
        state = _train_state(trainer)
        t0 = time.perf_counter()
        ckpt.save_state(os.path.join(tmp, "again.ckpt"), task, trainer.opts, trainer.path_state,
                        1, trainer.tokens)
        save_s = time.perf_counter() - t0
        d["TRAINER"]["OUTPUT_DIRECTORY"] = os.path.join(tmp, "resumed")
        cfg = Config(d)
        task2 = build_model(cfg, device="cuda").init(3)
        trainer2 = build_trainer(task2, cfg, evaluator=build_evaluator(task2, cfg))
        t0 = time.perf_counter()
        path_state, epoch, tokens = ckpt.load_state(last, task2, trainer2.opts)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        log(f"  last_state.ckpt: {os.path.getsize(last) / 1e6:.1f} MB; save {save_s:.2f} s, "
            f"load {load_s:.2f} s; card: {card}")
        trainer2.path_state, trainer2.tokens = path_state, tokens
        restored = [_nested_equal(a, b) for a, b in zip(state, _train_state(trainer2))]
        log(f"  resume: weights, Adam states, path state, tokens restored exactly: {restored}; "
            f"epoch {epoch}, tokens {tokens}")
        if not all(restored) or epoch != 1:
            raise AssertionError(f"resume state {restored}, epoch {epoch}")
        del task, trainer, evaluator
        t0 = time.perf_counter()
        trainer2.train(max_epochs=3, resume_from=last)
        recs = _finite_records(trainer2.out_dir)
        if [r["step"] for r in recs] != [0, 1] or trainer2.tokens != tokens + n_train * 5:
            raise AssertionError(f"resumed run: steps {[r['step'] for r in recs]}, tokens "
                                 f"{trainer2.tokens}")
        log(f"  resumed at epoch 2 and ran it in {time.perf_counter() - t0:.1f} s; tokens "
            f"{tokens} -> {trainer2.tokens}")
        del trainer2, task2
        log("  (b) the training entry point on configs/interactron.yaml")
        from_scratch_step(cfg_dict, tree, card)
        train_entry_point("configs/interactron.yaml", tree, card, last)
        log("  (c) fp32 lockstep vs serial evaluation records")
        lockstep_records(d, InteractronTask, Config, weights, card)
    return counts


# phase 12's configurations, and the depth of its fp32 card-vs-CPU checks
# (the CPU's share of the smoke's time)
OTHER_CONFIGS = ("interactron_random", "single_frame_baseline", "multi_frame_baseline",
                 "interactron_scaled")
PARITY_DEPTH = {"NUM_ENCODER_LAYERS": 2, "NUM_DECODER_LAYERS": 2, "NUM_LAYERS": 2}
# the depth of phase 7's one-episode train step card vs CPU: at the
# config's 6 + 6 + 4 its five fp32 CPU runs took 232 s of a 906.5 s smoke,
# at 3 + 3 + 2 134.6 s of a 1078.9 s one (H100 80GB HBM3, 700.00 W), and
# phase 15 needs the time
TRAIN_PARITY_DEPTH = {"NUM_ENCODER_LAYERS": 3, "NUM_DECODER_LAYERS": 3, "NUM_LAYERS": 2}
# and of the ViT-B/16 backbone there (12 layers in the model): the fp32
# train check's CPU runs at 12 took 141 s of the smoke's time
PARITY_VIT_LAYERS = 2


@contextlib.contextmanager
def vit_depth(layers):
    """Build ViT backbones with `layers` blocks inside the context."""
    from interactron_tpu_torch.models import detr, vit

    full = detr.ViT
    detr.ViT = lambda **kw: vit.ViT(num_layers=layers, **kw)
    try:
        yield
    finally:
        detr.ViT = full


def predict_parity(config_dict, Task, Config, weights):
    """Phase 12: a baseline's fp32 predict (no adaptation), card vs CPU:
    pred_logits and pred_boxes to 1e-3 x max|CPU| (cuDNN vs CPU conv sums,
    kernel vs plain attention), as phase 4 holds the detect on the same fast
    weights."""
    cfg = json.loads(json.dumps(config_dict))
    cfg["MODEL"]["DTYPE"] = "float32"
    ep = {"frames": synthetic_frames(1, size=int(cfg["MODEL"]["TEST_RESOLUTION"]))}
    res = {dev: Task(Config(cfg), device=dev).load_weights(weights).predict(ep)
           for dev in ("cpu", "cuda")}
    for key in ("pred_logits", "pred_boxes"):
        ref = res["cpu"][key]
        err = (res["cuda"][key].cpu() - ref).abs().max().item()
        tol = 1e-3 * ref.abs().max().item()
        log(f"  fp32 card vs CPU: predict {key} {tuple(ref.shape)} max_abs_err={err:.3e} "
            f"tol={tol:.3e} (1e-3 x max|CPU|: cuDNN vs CPU conv sums, kernel vs plain attention)")
        if not err <= tol:
            raise AssertionError(f"predict {key}: {err} > {tol}")


def other_configs(fa, C, card, tree):
    """Phase 12: every other shipped configuration at full width from disk.
    Per configuration: (a) fp32, card vs CPU at PARITY_DEPTH, weights from
    seed 0 with FrozenBatchNorm statistics calibrated on noise (phase 4's
    recipe): predict (phase 4's adaptive check, or `predict_parity`) and one
    train episode with dropout on (`train_parity`, with the second-order
    probe for the adaptive families); (b)
    bf16 at full depth over `tree`, weights calibrated on the tree's frames
    (phase 11's recipe): `Trainer.train` (batch 4, 2 epochs: the epoch-0 test
    epoch and evaluation, two train steps, a test epoch and evaluation) with
    the config's trainer and evaluator, and three predicts; the steps', the
    evaluations' and the predicts' launches against the counts of the module
    structure. Returns {name: {path: launch counts}} and the rates."""
    from interactron_tpu_torch import tasks
    from interactron_tpu_torch.data.episode_dataset import EpisodeDataset
    from interactron_tpu_torch.utils.config import (
        Config,
        build_evaluator,
        build_model,
        build_trainer,
        get_config,
    )

    classes = {"detr": tasks.DETRTask, "detr_multiframe": tasks.MultiFrameTask,
               "interactron_random": tasks.InteractronRandomTask,
               "interactron": tasks.InteractronTask}
    img_root, ann = tree
    paths, rates = {}, {}
    for name in OTHER_CONFIGS:
        t_cfg = time.perf_counter()
        cfg_dict = get_config(f"configs/{name}.yaml").to_dict()
        m = cfg_dict["MODEL"]
        Task, size = classes[m["TYPE"]], int(m["TEST_RESOLUTION"])
        log(f"  ({name}) MODEL.TYPE {m['TYPE']}, BACKBONE {m['BACKBONE']}, {size} px, "
            f"TRAINER.TYPE {cfg_dict['TRAINER']['TYPE']}, EVALUATOR.TYPE "
            f"{cfg_dict['EVALUATOR']['TYPE']}, {Task.__name__}")

        t0 = time.perf_counter()
        pcfg = json.loads(json.dumps(cfg_dict))
        pcfg["MODEL"].update(PARITY_DEPTH)
        log(f"  (a) fp32 card vs CPU at depth {PARITY_DEPTH} (ViT layers "
            f"{PARITY_VIT_LAYERS if m['BACKBONE'] == 'vit_b16' else 0})")
        with vit_depth(PARITY_VIT_LAYERS):
            pw = calibrated_weights(pcfg, Task, Config, synthetic_frames(0, size=size)[0],
                                    "cuda")
            if hasattr(Task, "adapt"):
                full_width_parity(pcfg, Task, Config, pw)
            else:
                predict_parity(pcfg, Task, Config, pw)
            # the adaptive families' second-order term alone, as phase 7 holds
            # it: their full step's gradient jumps under fp32 noise (matching,
            # clips)
            train_parity(pcfg, Task, Config, pw, C, probe=hasattr(Task, "adapt"))
        del pw
        log(f"  (a) took {time.perf_counter() - t0:.1f} s")

        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmp:
            d = disk_config(cfg_dict, tree, tmp, {
                ("TRAINER", "BATCH_SIZE"): 4, ("TRAINER", "MAX_EPOCHS"): 2,
                ("TRAINER", "SAVE_WINDOW"): 1})
            cfg = Config(d)
            calib = EpisodeDataset(img_root, ann, "test", resolution=size)
            weights = calibrated_weights(cfg_dict, Task, Config, np.concatenate(
                [calib.get_item(i)["frames"] for i in (0, 3)]), "cuda")
            if cfg_dict["EVALUATOR"]["TYPE"] == "interactive_evaluator":
                log("  (c) fp32 lockstep vs serial evaluation records")
                lockstep_records(d, Task, Config, weights, card)
            task = build_model(cfg, device="cuda").load_weights(weights)
            del weights
            evaluator = build_evaluator(task, cfg)
            trainer = build_trainer(task, cfg, evaluator=evaluator)
            steps, step_counts, evals, eval_counts, epochs = [], {}, [], {}, {"train": [],
                                                                               "test": []}

            def add(acc, launched):
                for k, v in launched.items():
                    acc[k] = acc.get(k, 0) + v

            torch.cuda.reset_peak_memory_stats()
            with instrument(trainer, "train_step",
                            lambda a, t, n: (steps.append(t), add(step_counts, n))), \
                    instrument(evaluator, "evaluate",
                               lambda a, t, n: (evals.append(t), add(eval_counts, n))), \
                    instrument(trainer, "_run_epoch", lambda a, t, _: epochs[a[0]].append(t)):
                fa.reset_launches()
                t0 = time.perf_counter()
                trainer.train()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = dict(fa.launches)
            peak = torch.cuda.max_memory_allocated() / 2**30
            recs = _finite_records(trainer.out_dir)
            for r in recs:
                log(f"  metrics.jsonl step {r['step']}: " + ", ".join(
                    f"{k} {v:.5g}" for k, v in r.items() if k not in ("step", "time")))
            n_train, n_eval = 4 * len(steps), len(evaluator.dataset)
            units = len(evals) * -(-n_eval // getattr(evaluator, "chunk", 1))
            checks = [
                ("train steps", step_counts,
                 {k: v * len(steps) for k, v in expected_train_launches(
                     cfg.MODEL, microbatches=len(task.microbatches(4))).items()}),
                ("evaluations", eval_counts,
                 {k: v * units for k, v in expected_episode_launches(
                     cfg.MODEL, d["EVALUATOR"]["TYPE"], C.NUM_QUERIES, C.NUM_FRAMES).items()}),
            ]

            # predict: the evaluator's input, three calls, the first one warm-up
            episode = {"frames": calib.get_item(1)["frames"][None]}
            fa.reset_launches()
            pr_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred = task.predict(episode)
                torch.cuda.synchronize()
                pr_ms.append(1e3 * (time.perf_counter() - t0))
            predict_counts = dict(fa.launches)
            checks.append(("predicts", predict_counts,
                           {k: 3 * v for k, v in expected_predict_launches(cfg.MODEL).items()}))
            nc = m["NUM_CLASSES"] + 1
            frames_out = 1 if hasattr(Task, "adapt") else C.NUM_FRAMES
            for key, shape in (("pred_logits", (1, frames_out, C.NUM_QUERIES, nc)),
                               ("pred_boxes", (1, frames_out, C.NUM_QUERIES, 4))):
                if tuple(pred[key].shape) != shape or not torch.isfinite(pred[key]).all():
                    raise AssertionError(f"{name} {key}: shape {tuple(pred[key].shape)} or "
                                         "non-finite")
            for label, got, want in checks:
                log(f"  launches of the {label}: {got} (expected {want})")
                if any(got.get(k, 0) != want.get(k, 0) for k in {*got, *want}):
                    raise AssertionError(f"{name} {label} launches {got} != {want}")
            per_episode = {k: v / n_train for k, v in step_counts.items() if v}
            (train_s,) = epochs["train"]
            rates[name] = {
                "train_eps": n_train / train_s, "step_eps": n_train / sum(steps),
                "eval_eps": n_eval / np.mean(evals), "predict_ms": float(np.mean(pr_ms[1:])),
                "peak_gib": peak, "launches_per_train_episode": per_episode}
            log(f"  ({name}) Trainer.train {wall:.1f} s; train epoch {rates[name]['train_eps']:.3f} "
                f"episodes/s ({n_train} episodes in {train_s:.2f} s; steps "
                f"{', '.join(f'{1e3 * t:.0f}' for t in steps)} ms, {rates[name]['step_eps']:.3f} "
                f"episodes/s); evaluation {rates[name]['eval_eps']:.3f} episodes/s ({n_eval} "
                f"episodes, {', '.join(f'{t:.2f}' for t in evals)} s); predict "
                f"{rates[name]['predict_ms']:.2f} ms (mean of 2 after the first, "
                f"{pr_ms[0]:.1f} ms); peak memory {peak:.2f} GiB; kernel launches a train "
                f"episode {per_episode}; card: {card}")
            paths[f"{name}_from_disk"] = counts
            paths[f"{name}_predict"] = predict_counts
            del task, evaluator, trainer
        log(f"  ({name}) took {time.perf_counter() - t_cfg:.1f} s")
    return paths, rates

# ---------------------------------------------------------------- phase 13


def reference_layout(state):
    """The port's interactron state dict (detector + FusionGPT) in the
    reference's own layout (the inverse of utils/convert_weights.py's
    `convert_detector` and `convert_fusion_gpt`): what a reference
    checkpoint of these weights would hold."""
    out = {}
    for name, v in state.items():
        v = v.detach().cpu().float().clone()
        grp, rest = name.split(".", 1)
        if grp == "detector":
            if rest.startswith("backbone."):
                key = rest[len("backbone."):]
                m = re.match(r"(layer\d)_block(\d+)\.(.*)", key)
                if m:
                    sub = m.group(3).replace("downsample_conv", "downsample.0").replace(
                        "downsample_bn", "downsample.1")
                    key = f"{m.group(1)}.{m.group(2)}.{sub}"
                out[f"backbone.0.body.{key}"] = v
                continue
            if rest == "input_proj.weight":
                out[rest] = v[:, :, None, None]
                continue
            if rest == "query_embed":
                out["query_embed.weight"] = v
                continue
            rest = re.sub(r"^bbox_embed\.layer(\d)", r"bbox_embed.layers.\1", rest)
            rest = re.sub(r"^encoder_layer(\d+)", r"transformer.encoder.layers.\1", rest)
            rest = re.sub(r"^decoder\.layer(\d+)", r"transformer.decoder.layers.\1", rest)
            rest = rest.replace("decoder.norm", "transformer.decoder.norm", 1) \
                if rest.startswith("decoder.norm") else rest
            rest = rest.replace(".cross_attn.", ".multihead_attn.")
            m = re.match(r"(.*\.(?:self_attn|multihead_attn))\.([qkv])_proj\.(weight|bias)$", rest)
            if m:  # packed in_proj, q/k/v rows in that order
                key = f"{m.group(1)}.in_proj_{m.group(3)}"
                parts = out.setdefault(key, {})
                parts[m.group(2)] = v
                if len(parts) == 3:
                    out[key] = torch.cat([parts[c] for c in "qkv"])
                continue
            out[rest] = v
        else:
            rest = re.sub(r"^heads\.(\w+_decoder)\.layer(\d)", r"\1.layers.\2", rest)
            rest = rest.replace("heads.logit_decoder", "logit_decoder")
            if rest == "seq_pos_embed":
                out["fusion.model.seq_pos_embed"] = v[None]
                continue
            if rest.startswith(("ln_f.", "head.")):
                rest = "model." + rest
            m = re.match(r"block(\d+)\.(.*)", rest)
            if m:
                sub = {"attn.q_proj": "attn.query", "attn.k_proj": "attn.key",
                       "attn.v_proj": "attn.value", "attn.out_proj": "attn.proj",
                       "mlp_fc": "mlp.0", "mlp_proj": "mlp.2"}
                tail = m.group(2)
                for a, b in sub.items():
                    if tail.startswith(a + "."):
                        tail = b + tail[len(a):]
                rest = f"model.blocks.{m.group(1)}.{tail}"
            out[f"fusion.{rest}"] = v
    return out


def timm_vit_b16(seed, grid=14, width=768, layers=12):
    """A seeded timm-layout ViT-B/16 state dict with a cls token and a
    `grid` x `grid` position table (14: a 224 px checkpoint)."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: 0.02 * torch.randn(*s, generator=gen)
    sd = {"patch_embed.proj.weight": r(width, 3, 16, 16), "patch_embed.proj.bias": r(width),
          "pos_embed": r(1, grid * grid + 1, width), "cls_token": r(1, 1, width),
          "norm.weight": torch.ones(width), "norm.bias": torch.zeros(width)}
    for i in range(layers):
        p = f"blocks.{i}"
        for ln in ("norm1", "norm2"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = torch.ones(width), torch.zeros(width)
        for name, o, n in (("attn.qkv", 3 * width, width), ("attn.proj", width, width),
                           ("mlp.fc1", 4 * width, width), ("mlp.fc2", width, 4 * width)):
            sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"] = r(o, n), r(o)
    return sd


_DP_CHILD = r'''
"""One torchrun rank of phase 13: (b) world 1 over NCCL, the plain step and
data_parallel_grads on one batch; (c) a rank of two over gloo on cuda:0."""
import json, os, sys
import numpy as np
import torch
from interactron_tpu_torch.ops import flash_attention as fa
from interactron_tpu_torch.parallel import mesh
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils.config import Config

mode, cfg_path, weights_path, batch_path, out = sys.argv[1:6]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
device = mesh.init_distributed("cuda", backend="gloo" if mode == "gloo2" else None)
r, w = mesh.rank(), mesh.world_size()
with open(cfg_path) as f:
    cfg = Config(json.load(f))
task = InteractronTask(cfg, device=device).load_weights(torch.load(weights_path))
data = np.load(batch_path)
batch = {k: data[k] for k in data.files}
fi = [int(x) for x in batch.pop("frame_index")]
n = len(fi) // w
local = {k: v[r * n:(r + 1) * n] for k, v in batch.items()}
gen = torch.Generator().manual_seed(0)
res = {"backend": torch.distributed.get_backend(), "device": str(device), "rank": r}
if mode == "nccl1":
    plain, pm, _ = task.grads_and_metrics(local, gen, task.init_path_state(8), train=False,
                                          frame_index=fi)
fa.reset_launches()
g, m, state = mesh.data_parallel_grads(task)(local, gen, task.init_path_state(8), train=False,
                                             frame_index=fi[r * n:(r + 1) * n])
torch.cuda.synchronize()
res["launches"] = {k: v for k, v in fa.launches.items() if v}
if mode == "nccl1":
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    same = [torch.equal(bits(g[grp][k]), bits(plain[grp][k])) for grp in plain for k in plain[grp]]
    res.update(leaves=len(same), equal=sum(same),
               nonfinite=sum(int(not torch.isfinite(x).all()) for d in g.values()
                             for x in d.values()),
               metrics_equal=all(torch.equal(bits(m[k]), bits(pm[k])) for k in pm))
else:
    torch.save({"grads": {grp: {k: v.cpu() for k, v in d.items()} for grp, d in g.items()},
                "metrics": {k: float(v) for k, v in m.items()},
                "state": {k: v.cpu() for k, v in state.items()}}, out)
mesh.shutdown_distributed()
print("RESULT " + json.dumps(res), flush=True)
'''


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp, name, script_text, args, local_ranks, env=None):
    """One child a rank of `script_text` (written to `tmp`), with torchrun's
    environment (LOCAL_RANK from `local_ranks`) and `args` after the
    script, each rank's output file last; started together. Returns their
    RESULT lines and output files."""
    script = os.path.join(tmp, f"{name}_child.py")
    with open(script, "w") as f:
        f.write(script_text)
    port = str(_free_port())
    repo = os.path.dirname(os.path.abspath(__file__))
    procs, outs = [], []
    for r, local_rank in enumerate(local_ranks):
        out = os.path.join(tmp, f"{name}_rank{r}.pt")
        e = dict(os.environ, RANK=str(r), WORLD_SIZE=str(len(local_ranks)),
                 LOCAL_RANK=str(local_rank), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                 PYTHONPATH=repo, **(env or {}))
        procs.append(subprocess.Popen([sys.executable, script, *args, out], cwd=repo, env=e,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        outs.append(out)
    results = []
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=400)
            if p.returncode != 0:
                log(stderr[-4000:])
                raise AssertionError(f"{name} rank {r} exited {p.returncode}")
            (line,) = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
            results.append(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results, outs


def torchrun_children(tmp, mode, cfg, weights, batch, frame_index, local_ranks):
    """One child of _DP_CHILD in `mode` a local rank of `local_ranks`
    (`run_ranks`): their RESULT lines and output files."""
    paths = {k: os.path.join(tmp, f"{mode}_{k}") for k in ("cfg.json", "weights.pt", "batch.npz")}
    with open(paths["cfg.json"], "w") as f:
        json.dump(cfg, f)
    torch.save({k: v.cpu() for k, v in weights.items()}, paths["weights.pt"])
    np.savez(paths["batch.npz"], frame_index=np.asarray(frame_index), **batch)
    return run_ranks(tmp, f"p13_{mode}", _DP_CHILD,
                     [mode, paths["cfg.json"], paths["weights.pt"], paths["batch.npz"]],
                     local_ranks, env={"CUBLAS_WORKSPACE_CONFIG": ":4096:8"})


def pretrained_and_parallel(cfg_dict, fa, C, card, tree):
    """Phase 13: (a) MODEL.WEIGHTS: a reference-layout DETR-R50-DC5 +
    FusionGPT `.pth` (seed 0's weights with FrozenBatchNorm statistics
    calibrated on the tree, as a trained detector's would be) at init: every
    converted leaf loaded (torch.equal to its source), one bf16 train step
    from it with its non-finite gradient leaves counted, the warning for a
    missing file, and a timm-layout ViT-B/16 (224 px, 14x14) resized into
    interactron_scaled's 19x19 grid, its predict finite. (b) world 1 over
    NCCL in a child under torchrun's environment: one full-width bf16 train
    step through `data_parallel_grads` in the split formulation, dropout
    off, frame indices fixed, torch.equal to the plain step. (c) two gloo
    ranks on cuda:0 at PARITY_DEPTH in fp32, dropout off: a batch of 4 split
    2 + 2, the summed gradients and mean metrics held to the one-process
    step of 4 at phase 7b's tolerance, and both ranks' merged path states
    equal. (d) `python -m interactron_tpu_torch.train` at RANK 0 of
    WORLD_SIZE 1 (NCCL), MODEL.WEIGHTS the `.pth` of (a), phase 11's cuts:
    exit 0 and rank 0's files written. Returns the launch counts of (a)'s
    in-process paths."""
    import warnings

    from interactron_tpu_torch.data.episode_dataset import EpisodeDataset, EpisodeLoader
    from interactron_tpu_torch.tasks import InteractronTask
    from interactron_tpu_torch.utils import convert_weights
    from interactron_tpu_torch.utils.config import Config, get_config

    paths = {}
    img_root, ann = tree
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p13_") as tmp:
        t0 = time.perf_counter()
        calib = EpisodeDataset(img_root, ann, "test")
        weights = calibrated_weights(cfg_dict, InteractronTask, Config, np.concatenate(
            [calib.get_item(i)["frames"] for i in (0, 3)]), device="cuda")
        ref = reference_layout(weights)
        pth = os.path.join(tmp, "detr-dc5-interactron.pth")
        torch.save({"model": ref}, pth)
        log(f"  (a) reference-layout .pth: {len(ref)} tensors, "
            f"{os.path.getsize(pth) / 1e6:.1f} MB (seed 0, FrozenBatchNorm statistics "
            f"calibrated on the tree)")
        d = json.loads(json.dumps(cfg_dict))
        d["MODEL"]["WEIGHTS"] = pth
        task = InteractronTask(Config(d), device="cuda").init(42)
        converted = convert_weights.convert_reference(convert_weights.read_torch(pth))
        state = task.state_dict()
        loaded = [k for k, v in converted.items()
                  if torch.equal(state[k].cpu(), torch.from_numpy(v))]
        source = [k for k in converted if torch.equal(weights[k].cpu(), state[k].cpu())]
        log(f"  MODEL.WEIGHTS: {len(loaded)} of {len(converted)} converted leaves loaded "
            f"torch.equal, {len(source)} equal to their source, of the task's {len(state)} "
            f"tensors")
        if len(loaded) != len(converted) or len(source) != len(converted) \
                or set(converted) != set(state):
            raise AssertionError("MODEL.WEIGHTS did not load every leaf")
        ds = EpisodeDataset(img_root, ann, "train", resolution=task.img_size,
                            max_boxes=task.max_boxes)
        batch = next(iter(EpisodeLoader(ds, 4, shuffle=False, num_workers=0)))
        fa.reset_launches()
        g, m, _ = task.grads_and_metrics(batch, torch.Generator().manual_seed(0),
                                         task.init_path_state(8), train=True)
        torch.cuda.synchronize()
        paths["pretrained_train_step"] = dict(fa.launches)
        bad = {grp: sum(int(not torch.isfinite(x).all()) for x in dd.values())
               for grp, dd in g.items()}
        log(f"  one bf16 train step of 4 episodes from those weights (INNER_BATCH "
            f"{task.inner_batch}, dropout on): total_loss {float(m['total_loss']):.4f}; "
            f"gradient leaves not finite {bad} of { {k: len(v) for k, v in g.items()} }; "
            f"launches {paths['pretrained_train_step']}; card: {card}")
        del task, g
        d["MODEL"]["WEIGHTS"] = os.path.join(tmp, "absent.ckpt")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            InteractronTask(Config(d), device="cpu").init(0)
        said = [str(w.message) for w in caught if "MODEL.WEIGHTS" in str(w.message)]
        log(f"  a missing MODEL.WEIGHTS warns: {said}")
        if said != [f"MODEL.WEIGHTS not found, random init: {d['MODEL']['WEIGHTS']}"]:
            raise AssertionError(f"missing-file warning {said}")

        vit = os.path.join(tmp, "vit-b16-224.pth")
        torch.save(timm_vit_b16(1), vit)
        sd = get_config("configs/interactron_scaled.yaml").to_dict()
        sd["MODEL"]["WEIGHTS"] = vit
        scaled = InteractronTask(Config(sd), device="cuda").init(0)
        conv = convert_weights.convert_vit_b16(convert_weights.read_torch(vit), grid=19)
        st = scaled.state_dict()
        vit_loaded = sum(torch.equal(st[k].cpu(), torch.from_numpy(v)) for k, v in conv.items())
        frames = synthetic_frames(5, size=scaled.img_size)
        fa.reset_launches()
        pred = scaled.predict({"frames": frames})
        torch.cuda.synchronize()
        paths["pretrained_vit_predict"] = dict(fa.launches)
        finite = all(bool(torch.isfinite(v).all()) for v in pred.values())
        log(f"  timm-layout ViT-B/16 (224 px, 14x14 + cls) into interactron_scaled: "
            f"{vit_loaded} of {len(conv)} leaves loaded torch.equal (pos_embed resized to "
            f"19x19 {tuple(st['detector.backbone.pos_embed'].shape)}); predict finite: "
            f"{finite}; launches {paths['pretrained_vit_predict']}")
        if vit_loaded != len(conv) or not finite:
            raise AssertionError(f"ViT load {vit_loaded}/{len(conv)}, predict finite {finite}")
        del scaled, pred
        log(f"  (a) took {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        bbatch = {k: v[:2] for k, v in batch.items() if k != "initial_image_path"}
        with switches(**SPLIT):
            (res,), _ = torchrun_children(tmp, "nccl1", cfg_dict, weights, bbatch, [2, 3],
                                          [0])
        log(f"  (b) world 1 over {res['backend']} on {res['device']}, split formulation, "
            f"bf16, the tree's first 2 episodes, dropout off: data_parallel_grads equal bit "
            f"for bit to the plain step on {res['equal']} of {res['leaves']} gradient leaves ({res['nonfinite']} "
            f"not finite), metrics equal {res['metrics_equal']}; launches {res['launches']}; "
            f"{time.perf_counter() - t0:.1f} s")
        if res["backend"] != "nccl" or res["equal"] != res["leaves"] or not res["metrics_equal"]:
            raise AssertionError(f"world-1 data parallel step differs: {res}")
        del weights

        t0 = time.perf_counter()
        pcfg = json.loads(json.dumps(cfg_dict))
        pcfg["MODEL"].update(PARITY_DEPTH, DTYPE="float32")
        pweights = calibrated_weights(pcfg, InteractronTask, Config, device="cuda")
        cbatch = synthetic_batch(7, 4, pcfg["MODEL"]["NUM_CLASSES"], C)
        fi = [2, 3, 1, 4]
        results, outs = torchrun_children(tmp, "gloo2", pcfg, pweights, cbatch, fi, [0, 0])
        ranks = [torch.load(o) for o in outs]
        model = InteractronTask(Config(pcfg), device="cuda").load_weights(pweights)
        one = {}
        for key, b in (("base", cbatch), ("moved", perturbed(cbatch))):
            g, m, state = model.grads_and_metrics(b, torch.Generator().manual_seed(0),
                                                  model.init_path_state(8), train=False,
                                                  frame_index=fi)
            one[key] = ({grp: {k: v.cpu() for k, v in dd.items()} for grp, dd in g.items()},
                        {k: float(v) for k, v in m.items()}, {k: v.cpu() for k, v in state.items()})
        del model
        norm = lambda dd: sum(torch.sum(x.double() ** 2) for x in dd.values()).sqrt().item()
        (gb, mb, sb), (gm, mm, _) = one["base"], one["moved"]
        for grp in gb:
            err = norm({k: ranks[0]["grads"][grp][k] - gb[grp][k] for k in gb[grp]}) / norm(gb[grp])
            sens = norm({k: gm[grp][k] - gb[grp][k] for k in gb[grp]}) / norm(gb[grp])
            tol = max(10 * sens, GRAD_FLOOR)
            log(f"  (c) 2 gloo ranks on cuda:0 (fp32, depth {PARITY_DEPTH}, 2 + 2 episodes) vs "
                f"one process of 4: {grp} gradient ||dp - one|| / ||one|| = {err:.3e} "
                f"tol={tol:.3e} (max of 10 x the card's own change, {sens:.3e}, and "
                f"{GRAD_FLOOR:g})")
            if not err <= tol:
                raise AssertionError(f"two-rank {grp} gradient: {err} > {tol}")
        for k, v in mb.items():
            if "loss" in k or k == "policy_reward":
                err, tol = abs(ranks[0]["metrics"][k] - v), max(1e-4 * abs(v), 10 * abs(mm[k] - v))
                log(f"  (c) metric {k}: ranks {ranks[0]['metrics'][k]:.6f} one process {v:.6f} "
                    f"err={err:.3e} tol={tol:.3e}")
                if not err <= tol:
                    raise AssertionError(f"two-rank metric {k}: {err} > {tol}")
        same_state = all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in sb)
        same_action = torch.equal(ranks[0]["state"]["action"], sb["action"])
        log(f"  (c) merged path state equal on both ranks: {same_state}; its actions equal to "
            f"the one-process step's: {same_action}; launches per rank "
            f"{[r['launches'] for r in results]}; {time.perf_counter() - t0:.1f} s")
        if not (same_state and same_action):
            raise AssertionError("two-rank path states differ")
        del pweights

        t0 = time.perf_counter()
        run_dir, files = train_entry_point(
            "configs/interactron.yaml", tree, card, None, weights=pth,
            env={"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())})
        log(f"  (d) rank 0 of world 1 wrote {files} in {run_dir}; "
            f"{time.perf_counter() - t0:.1f} s")
        if files != ["detector.ckpt", "last_state.ckpt", "logs"] or run_dir.endswith("-p0"):
            raise AssertionError(f"entry point at world 1 wrote {files} in {run_dir}")
    return paths


# ---------------------------------------------------------------- phase 14

_TP_CHILD = r'''
"""One rank of phase 14: a tp rank of a dp 1 x tp 2 grid on cuda:0 over gloo.
It joins the group through init_distributed, whose build barrier (the
kernels' build, a no-op after phase 2) it records; then, with the class
heads sharded, (a) the fp32 inner step, predict, 4 next_action calls and a
fusion pass, and (b) one bf16 served episode with its launch counts and the
bf16 predict's ms."""
import json, os, sys, time
import numpy as np
import torch
from interactron_tpu_torch.ops import cuda_build
from interactron_tpu_torch.ops import flash_attention as fa
from interactron_tpu_torch.parallel import mesh
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils.config import Config

cfg_path, weights_path, frames_path, out = sys.argv[1:5]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
build = {}


def record_build():
    build["start"] = time.time()
    build["built"] = sorted(cuda_build.build_all())
    build["end"] = time.time()


device = mesh.init_distributed("cuda:0", backend="gloo", build=record_build)
after = time.time()
grid = mesh.make_grid(dp=1, tp=2)
with open(cfg_path) as f:
    cfg = json.load(f)
weights = torch.load(weights_path)
frames = np.load(frames_path)
res = {"rank": mesh.rank(), "local_rank": int(os.environ["LOCAL_RANK"]), "device": device,
       "backend": torch.distributed.get_backend(), "build": build, "after_barrier": after}


def gathered(d, heads):
    """d on the host, each sharded head's (E, rows, in) leaf gathered on its
    rows."""
    out = {}
    for k, v in d.items():
        if k in heads:
            parts = [torch.empty_like(v) for _ in range(grid.tp)]
            torch.distributed.all_gather(parts, v.contiguous(), group=grid.tp_group)
            v = torch.cat(parts, 1)
        out[k] = v.cpu()
    return out


cfg32 = json.loads(json.dumps(cfg))
cfg32["MODEL"]["DTYPE"] = "float32"
task = InteractronTask(Config(cfg32), device=device).load_weights(weights)
res["sharded"] = mesh.shard_heads(task, grid)
heads = {n[len("detector."):] for n in res["sharded"] if n.startswith("detector.")}
fast, g, _ = task.adapt({"frames": frames})
pred = task.predict({"frames": frames})
actions = [int(task.next_action({"frames": frames[:, :s]})[0]) for s in range(1, 5)]
with torch.no_grad():
    fus = task.fusion_apply(task.detr_apply(None, task.frames({"frames": frames})[0]))
fast = gathered(fast, heads)
torch.save({"g": gathered(g, heads), "fast": {k: fast[k] for k in heads},
            "pred": {k: v.cpu() for k, v in pred.items()}, "actions": actions,
            "fusion_logits": fus["pred_logits"].cpu()}, out)
del task, fast, g, pred, fus

task = InteractronTask(Config(cfg), device=device).load_weights(weights)
mesh.shard_heads(task, grid)


def served():
    for s in range(1, 5):
        task.next_action({"frames": frames[:, :s]})
    return task.predict({"frames": frames})


served()  # warm-up
torch.cuda.synchronize()
fa.reset_launches()
pred16 = served()
torch.cuda.synchronize()
res["launches"] = dict(fa.launches)
res["bf16_finite"] = all(bool(torch.isfinite(v).all()) for v in pred16.values())
times = []
for _ in range(3):
    torch.cuda.synchronize()
    torch.distributed.barrier()
    t0 = time.perf_counter()
    task.predict({"frames": frames})
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - t0))
res["predict_ms"] = times
mesh.shutdown_distributed()
print("RESULT " + json.dumps(res), flush=True)
'''


def tp_children(tmp, cfg, weights, frames):
    """The two ranks of _TP_CHILD (LOCAL_RANK 0 and 1, both on cuda:0;
    `run_ranks`): their RESULT lines and their fp32 results."""
    paths = {k: os.path.join(tmp, f"tp_{k}") for k in ("cfg.json", "weights.pt", "frames.npy")}
    with open(paths["cfg.json"], "w") as f:
        json.dump(cfg, f)
    torch.save({k: v.cpu() for k, v in weights.items()}, paths["weights.pt"])
    np.save(paths["frames.npy"], frames)
    results, outs = run_ranks(tmp, "p14_tp", _TP_CHILD,
                              [paths["cfg.json"], paths["weights.pt"], paths["frames.npy"]], [0, 1])
    return results, [torch.load(o) for o in outs]


def tp_checks(rank_out, one, g_moved, before, base):
    """(name, err, tol, why) of one tp rank's fp32 results against the
    one-process ones (phase 14(a))."""
    norm = lambda d: sum(torch.sum(x.double() ** 2) for x in d.values()).sqrt().item()
    checks = []
    for key in PRED_KEYS:
        effect = (one["pred"][key][0, 0] - before[key]).abs().max().item()
        checks.append((f"predict {key} max_abs_err",
                       (rank_out["pred"][key] - one["pred"][key]).abs().max().item(),
                       0.1 * effect, f"0.1 x the adaptation's own effect, {effect:.3e}"))
    ref = one["fusion_logits"]
    checks.append(("fusion pred_logits (logit_decoder gathered) max_abs_err",
                   (rank_out["fusion_logits"] - ref).abs().max().item(),
                   1e-3 * ref.abs().max().item(), "1e-3 x max|one process|"))
    head = ["class_embed.weight", "class_embed.bias"]
    groups = {"class head g (weight gathered, bias)": head,
              "trunk g (every other adapted leaf)": [k for k in one["g"] if k not in head]}
    for label, keys in groups.items():
        b = {k: one["g"][k] for k in keys}
        err = norm({k: rank_out["g"][k] - b[k] for k in keys}) / norm(b)
        sens = norm({k: g_moved[k] - b[k] for k in keys}) / norm(b)
        checks.append((f"{label} ||tp - one|| / ||one||", err, max(10 * sens, GRAD_FLOOR),
                       f"max of 10 x the one-process step's own change, {sens:.3e}, and "
                       f"{GRAD_FLOOR:g}"))
    k = "class_embed.weight"
    b = one["fast"][k] - base[k]
    err = (torch.linalg.vector_norm((rank_out["fast"][k] - base[k] - b).double())
           / torch.linalg.vector_norm(b.double())).item()
    sens = (torch.linalg.vector_norm((g_moved[k] - one["g"][k]).double())
            / torch.linalg.vector_norm(one["g"][k].double())).item()
    checks.append(("class head fast-weight step (gathered) ||tp - one|| / ||one||", err,
                   max(10 * sens, GRAD_FLOOR), f"max of 10 x its g's own change, {sens:.3e}, "
                   f"and {GRAD_FLOOR:g}"))
    return checks


def grid_and_host(cfg_dict, fa, C, card, tree):
    """Phase 14: (a) two gloo ranks share cuda:0 as dp 1 x tp 2 at full
    width (configs/interactron.yaml, FrozenBatchNorm statistics calibrated
    on the tree as in phase 11) with the class heads sharded
    (`shard_heads`): in fp32, `predict`, 4 `next_action` calls and a fusion
    pass against the one-process ones at phase 4's card-vs-CPU rule (0.1 x
    the adaptation's own effect; the actions equal; the fusion's gathered
    logits, a forward on the same weights, to 1e-3 x max|one|), and the
    inner step's gradient (the class head gathered, and the trunk) and the
    head's adapted fast weights at phase 7b's rule (10 x the one-process
    step's own change when the frames move by 1e-6 relative, no less than
    GRAD_FLOOR): a gather whose backward summed the ranks' gradients, or a
    head input gradient not summed over tp, would move them by a factor; in
    bf16 each rank's served episode launches what phase 5's does, and the
    tp predict's ms stand beside the one-process predict's. (b) The build
    barrier of `init_distributed`: the rank at local rank 0 builds (the
    kernels are built, so the build is a no-op) and the other leaves the
    barrier after that build has ended. (c) The native JPEG loader on the
    tree: whether it was built (else why), its frames against the PIL path
    at 2e-6 (tests/test_native_loader.py's tolerance), and the episodes/s
    of both. Returns the launch counts of rank 0's served episode."""
    from interactron_tpu_torch.data.episode_dataset import EpisodeDataset
    from interactron_tpu_torch.native import fastloader_status
    from interactron_tpu_torch.tasks import InteractronTask
    from interactron_tpu_torch.utils.config import Config

    img_root, ann = tree
    t0 = time.perf_counter()
    calib = EpisodeDataset(img_root, ann, "test")
    weights = calibrated_weights(cfg_dict, InteractronTask, Config, np.concatenate(
        [calib.get_item(i)["frames"] for i in (0, 3)]), device="cuda")
    ep = {"frames": synthetic_frames(1)}
    cfg32 = json.loads(json.dumps(cfg_dict))
    cfg32["MODEL"]["DTYPE"] = "float32"
    model = InteractronTask(Config(cfg32), device="cuda").load_weights(weights)
    fast, g, prefix = model.adapt(ep)
    g_moved = {k: v.cpu() for k, v in model.adapt(perturbed(ep))[1].items()}
    one = {"g": {k: v.cpu() for k, v in g.items()}, "fast": {k: v.cpu() for k, v in fast.items()},
           "pred": {k: v.cpu() for k, v in model.predict(ep).items()},
           "actions": [int(model.next_action({"frames": ep["frames"][:, :s]})[0])
                       for s in range(1, 5)]}
    with torch.no_grad():
        before = model.detr_apply(None, prefix[0:1], stage="from_prefix")
        before = {k: before[k].cpu() for k in PRED_KEYS}
        one["fusion_logits"] = model.fusion_apply(
            model.detr_apply(None, model.frames(ep)[0]))["pred_logits"].cpu()
    base = {k: v.cpu() for k, v in model.detector.named_parameters()}
    del model, fast, g
    model = InteractronTask(Config(cfg_dict), device="cuda").load_weights(weights)
    model.predict(ep)
    one_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.predict(ep)
        torch.cuda.synchronize()
        one_ms.append(1e3 * (time.perf_counter() - t1))
    del model
    log(f"  (a) one process on cuda:0: the fp32 reference and the bf16 predict in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p14_") as tmp:
        results, outs = tp_children(tmp, cfg_dict, weights, ep["frames"])
    del weights
    sharded = ["detector.class_embed.weight", "fusion.heads.logit_decoder.weight"]
    want = expected_launches(C)
    for res, rank_out in zip(results, outs):
        r = res["rank"]
        if sorted(res["sharded"]) != sharded or res["backend"] != "gloo":
            raise AssertionError(f"rank {r} sharded {res['sharded']} over {res['backend']}")
        for name, err, tol, why in tp_checks(rank_out, one, g_moved, before, base):
            log(f"  (a) tp rank {r} fp32 vs one process: {name}={err:.3e} tol={tol:.3e} ({why})")
            if not err <= tol:
                raise AssertionError(f"phase 14 tp rank {r} {name}: {err} > {tol}")
        log(f"  (a) tp rank {r} actions {rank_out['actions']}, one process {one['actions']}")
        if rank_out["actions"] != one["actions"]:
            raise AssertionError(f"tp rank {r} actions {rank_out['actions']} != "
                                 f"{one['actions']}")
        log(f"  (a) tp rank {r} bf16 served episode (4 next_action + predict): launches "
            f"{res['launches']} (phase 5's {want}); predict finite {res['bf16_finite']}; "
            f"predict ms {', '.join(f'{t:.2f}' for t in res['predict_ms'])}")
        if res["launches"] != want or not res["bf16_finite"]:
            raise AssertionError(f"tp rank {r} launches {res['launches']} != {want}")
    log(f"  (a) bf16 predict of one episode: tp 2 (two processes sharing cuda:0) median "
        f"{np.median(results[0]['predict_ms']):.2f} ms on rank 0, one process median "
        f"{np.median(one_ms):.2f} ms ({', '.join(f'{t:.2f}' for t in one_ms)}); card: {card}")

    builders = [res for res in results if res["build"]]
    if len(builders) != 1 or builders[0]["local_rank"] != 0:
        raise AssertionError(f"build barrier: builders {builders}")
    start, end = builders[0]["build"]["start"], builders[0]["build"]["end"]
    for res in results:
        what = (f"built {res['build']['built'] or 'nothing (cached)'} in {end - start:.3f} s"
                if res["build"] else "did not build")
        log(f"  (b) build barrier: rank {res['rank']} (local rank {res['local_rank']}) {what}, "
            f"left the barrier {res['after_barrier'] - end:+.3f} s after the build ended")
        if res["after_barrier"] < end:
            raise AssertionError(f"rank {res['rank']} left the barrier before the build ended")
    log(f"  (a)-(b) the two ranks took {time.perf_counter() - t0:.1f} s")

    mod, why = fastloader_status()
    log(f"  (c) native JPEG loader: {'built' if mod else 'not built: ' + why}")
    ds = EpisodeDataset(img_root, ann, "test", resolution=C.IMG_SIZE)
    n, reps, rates, runs = len(ds), 3, {}, {}
    native = ds._native
    for path, loader in (("native", native), ("PIL", None)):
        ds._native = loader
        t1 = time.perf_counter()
        runs[path] = [ds.get_item(i) for _ in range(reps) for i in range(n)]
        rates[path] = n * reps / (time.perf_counter() - t1)
    ds._native = native
    err = max(np.abs(a["frames"] - b["frames"]).max()
              for a, b in zip(runs["native"][:n], runs["PIL"][:n]))
    log(f"  (c) get_item over the tree's {n} test episodes of {C.IMG_SIZE} px, one thread: "
        f"{'native' if mod else 'PIL (no native loader)'} path {rates['native']:.1f} episodes/s, "
        f"PIL path {rates['PIL']:.1f} episodes/s; frames max_abs_err {err:.3e} tol=2e-6")
    if not err <= 2e-6:
        raise AssertionError(f"native frames differ from PIL's: {err}")
    return {"tp_served_rank0": results[0]["launches"]}


# ---------------------------------------------------------------- phase 15

# the fast-weight conv formulations (MODEL keys over the config's) and the
# memory switches of phase 15
FORMULATIONS = {"grouped": {"SHIFT_CONV": False}, "shift": {},
                "adapted_im2col": {"ADAPTED_IM2COL": True}, "im2col": {"IM2COL_CONV": True}}


def with_keys(cfg, model=(), trainer=()):
    """A copy of the config dict with MODEL and TRAINER keys set."""
    c = json.loads(json.dumps(cfg))
    c["MODEL"].update(model)
    c["TRAINER"].update(trainer)
    return c


def _parity_run(cfg, Task, Config, weights, batch, what, env=(), train=False):
    """fp32 on the card: a predict of the batch's episodes in one call (with
    the unadapted detect, "before"), or a train step of them in one
    microbatch (frame indices 2, 3; dropout on with `train`, from a seeded
    CPU generator)."""
    with switches(**dict(env)):
        model = Task(Config(cfg), device="cuda").load_weights(weights)
        if what == "predict":
            pred = model.predict({"frames": batch["frames"]})
            with torch.no_grad():
                before = model.detr_apply(None, model.frames(batch)[:, 0])
            return {"pred": {k: v.cpu() for k, v in pred.items()},
                    "before": {k: before[k][:, None].cpu() for k in pred}}
        gen = torch.Generator().manual_seed(11) if train else None
        grads, m, _ = model.grads_and_metrics(batch, gen, model.init_path_state(8), train=train,
                                              frame_index=[2, 3][:len(batch["frames"])])
        return {"grads": {grp: {n: x.cpu() for n, x in d.items()} for grp, d in grads.items()},
                "m": {k: float(v) for k, v in m.items()}}


def _equal_runs(a, b):
    return (a["m"] == b["m"] and all(torch.equal(x, b["grads"][grp][n])
                                     for grp, d in a["grads"].items() for n, x in d.items()))


def bf16_cell(cfg, Task, Config, Trainer, weights, fa, C, model_keys=(), trainer_keys=(),
              episodes=4, steps=3, predict=True, profile=True):
    """Phase 15(c): full width, bf16, one warm-up step and `steps` timed
    train steps of `episodes` episodes (dropout on), each step's launches,
    peak GiB over the timed steps, with `profile` a profiled step; then with
    `predict` a lockstep predict of CHUNK (a warm-up call, 2 timed, with
    `profile` a profiled one) with its launches and peak. The launches are
    held to the module structure's unless the cell checkpoints (its
    recomputation relaunches)."""
    from interactron_tpu_torch.models.layers import conv_calls

    c = with_keys(cfg, model_keys, trainer_keys)
    model = Task(Config(c), device="cuda").load_weights(weights)
    trainer = Trainer(model, model.config, path_rows=64)
    gen = torch.Generator().manual_seed(0)
    batches = [synthetic_batch(20 + i, episodes, c["MODEL"]["NUM_CLASSES"], C)
               for i in range(steps + 1)]
    trainer.train_step(batches[0], gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    conv_calls.update(dict.fromkeys(conv_calls, 0))
    step_ms = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        metrics = trainer.train_step(b, gen)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if not all(np.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite train metrics {metrics}")
    out = {"train_ms": float(np.mean(step_ms)), "train_launches": dict(fa.launches),
           "train_convs": {k: n // steps for k, n in conv_calls.items() if n},
           "train_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    per_step = {k: n // steps for k, n in out["train_launches"].items()}
    if not dict(trainer_keys).get("REMAT"):
        want = expected_train_launches(model.config.MODEL, False,
                                       len(model.microbatches(episodes)))
        if per_step != want or any(n % steps for n in out["train_launches"].values()):
            raise AssertionError(f"train launches a step {per_step} != {want}")
    if profile:
        out["train_profile"] = profile_run(lambda: trainer.train_step(batches[0], gen), warm=False,
                                           quiet=True)
    if predict:
        frames = np.concatenate([synthetic_frames(200 + e) for e in range(CHUNK)])
        model.predict({"frames": frames})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        conv_calls.update(dict.fromkeys(conv_calls, 0))
        pr_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            pred = model.predict({"frames": frames})
            torch.cuda.synchronize()
            pr_ms.append(1e3 * (time.perf_counter() - t0))
        if not all(torch.isfinite(v).all() for v in pred.values()):
            raise AssertionError("non-finite lockstep predictions")
        out.update(predict_ms=float(np.mean(pr_ms)), predict_launches=dict(fa.launches),
                   predict_convs={k: n // 2 for k, n in conv_calls.items() if n},
                   predict_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        want = {k: 2 * n for k, n in expected_predict_launches(model.config.MODEL).items()}
        if out["predict_launches"] != want:
            raise AssertionError(f"predict launches {out['predict_launches']} != {want}")
        if profile:
            out["predict_profile"] = profile_run(lambda: model.predict({"frames": frames}),
                                                 warm=False, quiet=True)
    del model, trainer
    torch.cuda.empty_cache()
    return out


def _layer4_conv(e, f, dtype):
    """A fast-weight conv at layer4's shape (C = O = 512, 19x19, dilation 2)
    with E per-episode kernels, and seeded frames (E*F, ...), output
    gradients and kernels on the card; `run(scope)` gives its output, dX and
    per-episode dW inside a conv scope."""
    from torch.func import functional_call

    from interactron_tpu_torch.models import layers as tl

    conv = tl.Conv2d(512, 512, 3, 1, 2, 2, dtype=dtype).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = (torch.randn((e, 512, 512, 3, 3), device="cuda", generator=gen) * 0.02).to(dtype)
    x = torch.randn((e * f, 512, 19, 19), device="cuda", generator=gen).to(dtype)
    dy = torch.randn((e * f, 512, 19, 19), device="cuda", generator=gen).to(dtype)
    w.requires_grad_(True)
    x.requires_grad_(True)

    def run(scope):
        with scope:
            y = functional_call(conv, {"weight": w}, (x,))
        return (y, *torch.autograd.grad(y, (x, w), dy))

    return run


def _conv_scope(name):
    """The conv scope of a formulation: "grouped", "shift" or "im2col"."""
    from interactron_tpu_torch.models import layers as tl

    return {"grouped": contextlib.nullcontext, "shift": tl.episode_shift_convs,
            "im2col": tl.im2col_convs}[name]()


def conv_layer_parity():
    """Phase 15(a): one fast-weight conv at layer4's shape in fp32 (TF32
    off), E=4 episodes of F=5 frames: the shift and im2col forms' output, dX
    and per-episode dW against the grouped conv's, each to 1e-5 of the
    grouped one's largest entry (fp32 sums in another order; a wrong tap,
    flip or episode is O(1))."""
    run = _layer4_conv(4, 5, torch.float32)
    ref = run(_conv_scope("grouped"))
    for name in ("shift", "im2col"):
        got = run(_conv_scope(name))
        for what, a, b in zip(("output", "dX", "dW"), got, ref):
            err = ((a - b).abs().max() / b.abs().max()).item()
            log(f"  (a) fp32 layer4 conv, {name} vs grouped: {what} max_abs_err / max|grouped| "
                f"{err:.3e} tol=1e-5")
            if not err <= 1e-5:
                raise AssertionError(f"layer4 conv {name} {what}: {err}")
    del run, ref
    torch.cuda.empty_cache()


def conv_forms_timed():
    """Phase 15(c): one fast-weight conv at layer4's shape in bf16, forward
    and backward (dX and per-episode dW), device ms in each formulation, at
    a train microbatch (E=4 episodes of F=5 frames) and at a lockstep
    predict's frame-0 detect (E=10, F=1), against the bound at the bf16
    peak; each form's results held to the grouped conv's at 2e-2 of its
    largest entry (bf16 rounding, the sums in another order)."""
    for e, f in ((4, 5), (10, 1)):
        run = _layer4_conv(e, f, torch.bfloat16)
        ref = run(_conv_scope("grouped"))
        times = {}
        for name in ("grouped", "shift", "im2col"):
            got = run(_conv_scope(name))
            err = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                      for a, b in zip(got, ref))
            if not err <= 2e-2:
                raise AssertionError(f"bf16 layer4 conv {name}: {err}")
            times[name] = cuda_ms(lambda: run(_conv_scope(name)), iters=10)
        bound = 3 * 2 * e * f * 361 * 512 * 512 * 9 / PEAK_FLOPS * 1e3
        log(f"  one layer4 conv, E={e} F={f}, forward + backward, device ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
            + f"; bound {bound:.4f} (bf16 peak)")
        del run, ref
    torch.cuda.empty_cache()


def _cell_line(name, r, prof, pred):
    """One bf16 cell's log line (and its Conv2d forwards by formulation
    held to the cell's)."""
    convs = {what: r.get(f"{what}_convs", {}) for what in ("train", "predict")}
    # IM2COL_CONV leaves the fast-weight passes' stride-1 3x3 convs to the
    # default SHIFT_CONV, which JAX's Conv2d tries first
    want = {"grouped": set(), "adapted_im2col": {"im2col"},
            "im2col": {"shift", "im2col"}}.get(name, {"shift"})
    if {f for d in convs.values() for f in ("shift", "im2col") if d.get(f)} != want:
        raise AssertionError(f"{name}: Conv2d forwards by formulation {convs}, not {want}")
    line = (f"  {name}: Conv2d forwards by formulation, a train step {convs['train']}, a "
            f"predict {convs['predict']}; train {r['train_ms']:.1f} ms a step of 4, peak "
            f"{r['train_peak_gib']:.2f} GiB, launches a step "
            f"{ {k: v // 3 for k, v in r['train_launches'].items() if v} }")
    if prof:
        tp = r["train_profile"]
        line += (f", device {tp['device_ms']:.2f} ms profiled, fast-weight convs "
                 f"{tp['conv_ms']:.2f} ms in {tp['conv_launches']} launches")
    if pred:
        line += (f"; lockstep predict of {CHUNK} {r['predict_ms']:.2f} ms, peak "
                 f"{r['predict_peak_gib']:.2f} GiB")
        if prof:
            pp = r["predict_profile"]
            line += (f", device {pp['device_ms']:.2f} ms, fast-weight convs "
                     f"{pp['conv_ms']:.2f} ms in {pp['conv_launches']} launches")
    return line


def formulations_and_switches(cfg_dict, pcfg, Task, Config, Trainer, weights, pweights, C, fa,
                              card, shift_profiles):
    """Phase 15: the fast-weight conv formulations and the memory switches.
    (a) fp32 at PARITY_DEPTH, dropout off: each formulation's batched
    predict of BATCHED episodes and train step of BATCHED at INNER_BATCH
    BATCHED against the grouped formulation's on the card (phase 4b's and
    7b's rules; the sensitivity from the grouped step on frames moved by
    1e-6). (b) fp32 at PARITY_DEPTH, dropout on: the train step with
    TRAINER.REMAT on and with MODEL.REMAT_DROPOUT off against the defaults
    (7b's rule), and in the split formulation with cuDNN's deterministic
    algorithms the same step twice bit-equal with each switch on. (c) bf16
    at full width: each formulation's and
    each switch's train and lockstep predict times, device ms, fast-weight
    conv ms, launches and peak memory (`bf16_cell`; the switches' cells
    without predict, which they leave as it is, and MODEL.REMAT_DROPOUT's
    without a profile; the default's profiles are phases 9's and 6's,
    `shift_profiles`, where they ran); REMAT's peak also at a batch of 8 at
    INNER_BATCH 8. Returns the launch counts by path."""
    n = BATCHED
    batch = synthetic_batch(7, n, pcfg["MODEL"]["NUM_CLASSES"], C)
    cfg_n = with_keys(pcfg, trainer={"INNER_BATCH": n})
    t0 = time.perf_counter()
    conv_layer_parity()
    log(f"  (a) fp32 at depth {PARITY_DEPTH}, {n} episodes, dropout off: each formulation "
        "against the grouped conv on the card")
    ref = {what: _parity_run(with_keys(cfg_n, FORMULATIONS["grouped"]), Task, Config, pweights,
                             batch, what) for what in ("predict", "train")}
    moved = _parity_run(with_keys(cfg_n, FORMULATIONS["grouped"]), Task, Config, pweights,
                        perturbed(batch), "train")
    for name, keys in FORMULATIONS.items():
        if name == "grouped":
            continue
        c = with_keys(cfg_n, keys)
        hold_predict(f"fp32 {name} vs grouped: predict of {n} episodes",
                     _parity_run(c, Task, Config, pweights, batch, "predict"), ref["predict"])
        hold_train(f"fp32 {name} vs grouped: train step of {n} episodes",
                   _parity_run(c, Task, Config, pweights, batch, "train"), ref["train"],
                   ref["train"], [moved], "grouped step's")
    log(f"  (a) took {time.perf_counter() - t0:.1f} s")

    log(f"  (b) fp32 at depth {PARITY_DEPTH}, dropout on: TRAINER.REMAT and MODEL.REMAT_DROPOUT")
    t0 = time.perf_counter()
    switch_keys = {"REMAT on": ((), {"REMAT": True}),
                   "REMAT_DROPOUT off": ({"REMAT_DROPOUT": False}, ())}
    run = lambda m, t, b, env=(): _parity_run(with_keys(cfg_n, m, t), Task, Config, pweights, b,
                                              "train", env, train=True)
    base, moved = run((), (), batch), run((), (), perturbed(batch))
    for label, (m, t) in switch_keys.items():
        hold_train(f"fp32 {label} vs the defaults: train step of {n} episodes, dropout on",
                   run(m, t, batch), base, base, [moved], "defaults' step's")
    # bitwise reproducible: the split formulation, and cuDNN's deterministic
    # algorithms (as phase 13(b)); without them two fp32 steps differ in
    # every formulation, the grouped one too
    split, det = {}, torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, (m, t) in (("REMAT on", switch_keys["REMAT on"]),
                              ("REMAT_DROPOUT on", ((), ()))):
            a, b = (run(m, t, batch, SPLIT) for _ in range(2))
            same = _equal_runs(a, b)
            split[label] = a
            log(f"  split formulation, cuDNN deterministic, {label}: the same step twice "
                f"torch.equal: {same}")
            if not same:
                raise AssertionError(f"split formulation, {label}: two runs of one step differ")
    finally:
        torch.backends.cudnn.deterministic = det
    log(f"  split formulation: REMAT on and off torch.equal: "
        f"{_equal_runs(split['REMAT on'], split['REMAT_DROPOUT on'])} (printed only)")
    log(f"  (b) took {time.perf_counter() - t0:.1f} s")

    log(f"  (c) bf16 at full width: 3 train steps of 4 episodes at INNER_BATCH "
        f"{cfg_dict['TRAINER']['INNER_BATCH']} and a lockstep predict of {CHUNK} a cell")
    t0 = time.perf_counter()
    # name: (MODEL keys, TRAINER keys, profile, predict); the switches
    # leave predict as it is (no dropout, no checkpoint); phase 16 profiles
    # the cells not profiled here
    cells = {name: (keys, (), name != "im2col", True) for name, keys in FORMULATIONS.items()}
    cells.update({"REMAT on": ((), {"REMAT": True}, False, False),
                  "REMAT_DROPOUT off": ({"REMAT_DROPOUT": False}, (), False, False)})
    paths = {}
    for name, (m, t, prof, pred) in cells.items():
        t1 = time.perf_counter()
        reuse = name == "shift" and len(shift_profiles) == 2
        r = bf16_cell(cfg_dict, Task, Config, Trainer, weights, fa, C, m, t, predict=pred,
                      profile=prof and not reuse)
        if reuse:
            r.update(train_profile=shift_profiles["train"],
                     predict_profile=shift_profiles["predict"])
        paths[f"p15 {name} train"] = r["train_launches"]
        if pred:
            paths[f"p15 {name} predict"] = r["predict_launches"]
        log(_cell_line(name, r, prof, pred) + (" (profiles: phases 9 and 6)" if reuse else "")
            + f" ({time.perf_counter() - t1:.1f} s)")
    conv_forms_timed()
    log(f"  (c) took {time.perf_counter() - t0:.1f} s; card: {card}")
    return paths


def remat_profiles(cfg_dict, Task, Config, Trainer, weights, C, fa, card):
    """Phase 16 (only when asked for): the bf16 cells phase 15 does not
    profile, IM2COL_CONV's and TRAINER.REMAT's, profiled; and REMAT's peak
    at a batch of 8 at INNER_BATCH 8, on and off."""
    for name, m, t, pred in (("im2col", FORMULATIONS["im2col"], (), True),
                             ("REMAT on", (), {"REMAT": True}, False)):
        t1 = time.perf_counter()
        r = bf16_cell(cfg_dict, Task, Config, Trainer, weights, fa, C, m, t, predict=pred)
        log(_cell_line(name, r, True, pred) + f" ({time.perf_counter() - t1:.1f} s)")
    for remat in (False, True):
        r = bf16_cell(cfg_dict, Task, Config, Trainer, weights, fa, C, (),
                      {"INNER_BATCH": 8, "REMAT": remat} if remat else {"INNER_BATCH": 8},
                      episodes=8, steps=1, predict=False, profile=False)
        log(f"  REMAT {'on' if remat else 'off'} at a batch of 8, INNER_BATCH 8: train "
            f"{r['train_ms']:.1f} ms a step (one after a warm-up), peak "
            f"{r['train_peak_gib']:.2f} GiB")
    log(f"  card: {card}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--phases", default="all",
                        help="comma-separated phases 3-16 to run after 1 and 2 (a partial run "
                             "for development: it prints no kernels line and no ok line); all "
                             "is 3-15")
    args = parser.parse_args(argv)
    wanted = set(range(3, 16)) if args.phases == "all" else {int(p) for p in
                                                             args.phases.split(",")}
    run = lambda phase: phase in wanted
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from interactron_tpu_torch.engine.trainer import Trainer
        from interactron_tpu_torch.ops import cuda_build
        from interactron_tpu_torch.ops import flash_attention as fa
        from interactron_tpu_torch.tasks import InteractronTask
        from interactron_tpu_torch.utils import constants as C
        from interactron_tpu_torch.utils.config import Config, get_config
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1

    for key in ("FLASH_BWD", "FLASH_DKV", "SO_MERGED"):
        os.environ.pop(key, None)  # phases 1-9 run the default (merged) formulation
    t_start = time.perf_counter()
    card = device_line()
    log(f"[1] device: {card}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    log(f"[2] built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s, "
        "one nvcc per library, all at once")
    for name, (rep, secs) in sorted(reports.items()):
        log(f"    {name}: {secs:.1f} s")
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    sass_check(cuda_build)

    kres, paths = {}, {}
    shift_profiles = {}  # phases 6 and 9 profile the default formulation for phase 15
    if run(3):
        log("[3] kernels vs plain versions")
        t3 = time.perf_counter()
        kres = check_kernels(fa)
        log("  (b) the seven wgmma kernels at ragged shapes")
        check_ragged(fa)
        log(f"  phase 3 took {time.perf_counter() - t3:.1f} s")

    cfg_dict = get_config("configs/interactron.yaml").to_dict()
    weights = (calibrated_weights(cfg_dict, InteractronTask, Config)
               if wanted & {*range(4, 11), 15, 16} else None)
    if run(4) or run(7) or run(15):
        # phases 4b, 7, 7b and 15: fp32 at PARITY_DEPTH, weights calibrated there
        pcfg = json.loads(json.dumps(cfg_dict))
        pcfg["MODEL"].update(PARITY_DEPTH, DTYPE="float32")
        pweights = calibrated_weights(pcfg, InteractronTask, Config, device="cuda")
    if run(4):
        log("[4] full-width fp32 predict, card vs CPU")
        full_width_parity(cfg_dict, InteractronTask, Config, weights)
        log(f"  (b) a batched predict of {BATCHED} episodes at depth {PARITY_DEPTH}, dropout off")
        batched_parity(pcfg, InteractronTask, Config, pweights, C, "predict")

    if run(5) or run(6):
        log("[5] served path in bf16: next_action x4 + predict per episode, then in lockstep "
            f"chunks of {CHUNK}")
        model = InteractronTask(Config(cfg_dict), device="cuda").load_weights(weights)
        paths["served"], na_ms, pr_ms, ep_ms = served_path(model, fa, C)
        steady = pr_ms[1:]
        log(f"  predict: {1e3 / np.mean(steady):.3f} episodes/s (mean of {len(steady)} episodes "
            f"after the first, {np.mean(steady):.2f} ms each; first {pr_ms[0]:.1f} ms); "
            f"next_action: median {np.median(na_ms[4:]):.2f} ms over {len(na_ms) - 4} calls "
            f"after the first episode; served episodes (next_action x4 + predict) "
            f"{1e3 / np.mean(ep_ms[1:]):.3f} episodes/s; card: {card}")
        paths["served_lockstep"], na_ms, pr_ms, ch_ms = served_path(model, fa, C, 2 * CHUNK,
                                                                    chunk=CHUNK)
        log(f"  lockstep chunk of {CHUNK}: predict {1e3 * CHUNK / pr_ms[1]:.3f} episodes/s "
            f"({pr_ms[1]:.2f} ms a chunk, the second; first {pr_ms[0]:.1f} ms); next_action "
            f"median {np.median(na_ms[4:]):.2f} ms a call of {CHUNK}; served episodes "
            f"{1e3 * CHUNK / ch_ms[1]:.3f} episodes/s (serial above: "
            f"{1e3 / np.mean(ep_ms[1:]):.3f}); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {card}")

        log("[6] where the time goes: one bf16 predict episode under torch.profiler, then one "
            f"lockstep predict of {CHUNK}")
        frames = synthetic_frames(200)
        profile_run(lambda: model.predict({"frames": frames}))
        frames = np.concatenate([synthetic_frames(200 + e) for e in range(CHUNK)])
        shift_profiles["predict"] = profile_run(lambda: model.predict({"frames": frames}))
        del model

    if run(7):
        log(f"[7] full-width fp32 train step (one episode, dropout on) at depth "
            f"{TRAIN_PARITY_DEPTH}, card vs CPU")
        tcfg = json.loads(json.dumps(cfg_dict))
        tcfg["MODEL"].update(TRAIN_PARITY_DEPTH, DTYPE="float32")
        train_parity(tcfg, InteractronTask, Config,
                     calibrated_weights(tcfg, InteractronTask, Config, device="cuda"), C)
        log(f"  (b) a batched train step of {BATCHED} episodes (INNER_BATCH {BATCHED}) at depth "
            f"{PARITY_DEPTH}, dropout off")
        batched_parity(pcfg, InteractronTask, Config, pweights, C, "train")

    if run(8) or run(9):
        log(f"[8] bf16 training: 3 steps of 4 episodes at INNER_BATCH "
            f"{cfg_dict['TRAINER']['INNER_BATCH']} (config BATCH_SIZE "
            f"{cfg_dict['TRAINER']['BATCH_SIZE']} cut to 4 for time), dropout on, then one "
            "step at INNER_BATCH 1")
        model = InteractronTask(Config(cfg_dict), device="cuda").load_weights(weights)
        regions = {}
        torch.cuda.reset_peak_memory_stats()
        with mask_regions(fa, regions):
            paths["train"], step_ms, trainer, batch, serial_ms = train_bf16(model, fa, C, Trainer)
        steady = step_ms[1:]
        log(f"  train: {4e3 / np.mean(steady):.3f} episodes/s, {np.mean(steady):.1f} ms per step "
            f"of 4 episodes (mean of {len(steady)} steps after the first, {step_ms[0]:.1f} ms); "
            f"INNER_BATCH 1: {4e3 / serial_ms:.3f} episodes/s ({serial_ms:.1f} ms); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {card}")

        kres[("module", "mask")] = module_mask(fa, regions, 4 * 4)

        log("[9] where the time goes: one bf16 train step of 4 episodes (one microbatch) under "
            "torch.profiler")
        gen = torch.Generator().manual_seed(1)
        shift_profiles["train"] = profile_run(lambda: trainer.train_step(batch, gen))
        del model, trainer

    if run(10):
        t10 = time.perf_counter()
        log("[10] the split formulation: FLASH_BWD=split SO_MERGED=0")
        log("  (a) fp32 on the card, split vs merged")
        split_parity(cfg_dict, InteractronTask, Config, weights, C, fa)
        log("  (b) bf16 at full width, split")
        model = InteractronTask(Config(cfg_dict), device="cuda").load_weights(weights)
        with switches(**SPLIT):
            log(f"  formulation {fa.formulation()}")
            paths["served_split"], na_ms, pr_ms, _ = served_path(model, fa, C, split=True)
            paths["train_split"], step_ms, trainer, batch, serial_ms = train_bf16(
                model, fa, C, Trainer, split=True)
            steady, steady_step = pr_ms[1:], step_ms[1:]
            log(f"  split predict: {1e3 / np.mean(steady):.3f} episodes/s "
                f"({np.mean(steady):.2f} ms each after the first); next_action median "
                f"{np.median(na_ms[4:]):.2f} ms; train: {4e3 / np.mean(steady_step):.3f} "
                f"episodes/s ({np.mean(steady_step):.1f} ms per step of 4 episodes after the "
                f"first; INNER_BATCH 1 {serial_ms:.1f} ms); card: {card}")
            with switches(FLASH_DKV="blocked"):
                log(f"  (c) one served episode, formulation {fa.formulation()}")
                paths["served_split_dkv_blocked"] = served_path(model, fa, C, episodes=1,
                                                                split=True)[0]
            log("  (d) where the time goes: one split bf16 train step of 4 episodes under "
                "torch.profiler")
            gen = torch.Generator().manual_seed(1)
            profile_run(lambda: trainer.train_step(batch, gen))
        log(f"  phase 10 took {time.perf_counter() - t10:.1f} s")
        del model, trainer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tree_") as tmp:
        tree = make_tree(tmp, C) if wanted & {11, 12, 13, 14} else None
        if run(11):
            t11 = time.perf_counter()
            log("[11] train and evaluate from disk: Trainer.train over a JPEG tree, the "
                "closed-loop evaluation with AP, checkpoints and a resume")
            paths["train_from_disk"] = train_from_disk(cfg_dict, fa, C, card, tree)
            log(f"  phase 11 took {time.perf_counter() - t11:.1f} s")
        if run(12):
            t12 = time.perf_counter()
            log("[12] the other shipped configurations at full width from disk: "
                + ", ".join(OTHER_CONFIGS))
            other_paths, _ = other_configs(fa, C, card, tree)
            paths.update(other_paths)
            log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")
        if run(13):
            t13 = time.perf_counter()
            log("[13] pretrained_and_parallel: MODEL.WEIGHTS from reference-layout files, "
                "episode data parallelism over torch.distributed")
            paths.update(pretrained_and_parallel(cfg_dict, fa, C, card, tree))
            log(f"  phase 13 took {time.perf_counter() - t13:.1f} s")
        if run(14):
            t14 = time.perf_counter()
            log("[14] the grid and the host modules: tp-sharded class heads on two ranks of "
                "cuda:0, the kernel build barrier, the native JPEG loader")
            paths.update(grid_and_host(cfg_dict, fa, C, card, tree))
            log(f"  phase 14 took {time.perf_counter() - t14:.1f} s")
    if run(15):
        t15 = time.perf_counter()
        log("[15] the fast-weight conv formulations (MODEL.SHIFT_CONV, ADAPTED_IM2COL, "
            "IM2COL_CONV) and the memory switches (TRAINER.REMAT, MODEL.REMAT_DROPOUT)")
        paths.update(formulations_and_switches(cfg_dict, pcfg, InteractronTask, Config, Trainer,
                                               weights, pweights, C, fa, card,
                                               shift_profiles))
        log(f"  phase 15 took {time.perf_counter() - t15:.1f} s")
    if run(16):
        t16 = time.perf_counter()
        log("[16] the profiles phase 15 leaves out: IM2COL_CONV and TRAINER.REMAT profiled, "
            "REMAT at a batch of 8")
        remat_profiles(cfg_dict, InteractronTask, Config, Trainer, weights, C, fa, card)
        log(f"  phase 16 took {time.perf_counter() - t16:.1f} s")
    if run(4) or run(7) or run(15):
        del pweights
    del weights

    if wanted != set(range(3, 16)):
        log(f"total {time.perf_counter() - t_start:.1f} s")
        log(f"partial run (phases 1, 2, {sorted(wanted)}): no kernels line, no ok line")
        return 0
    kernels = []
    at = "fusion B=1 T=S=2060 H=8 D=64 bf16"
    tpu = "interactron_tpu/ops/flash_attention.py"
    library = {"fwd": "F.scaled_dot_product_attention",
               "bwd": "SDPA's autograd backward",
               "dq": "SDPA's autograd backward (dq, dk, dv together: the flash_dq + flash_dkv "
                     "pair's yardstick)"}
    library["dkv"] = library["dq"]
    for kname, key, replaces, errs in (
        ("flash_fwd", "fwd", f"{tpu}:92", ("O", "L")),
        ("flash_bwd", "bwd", f"{tpu}:299", ("dq", "dk", "dv")),
        ("flash_dq", "dq", f"{tpu}:138", ("dq_split",)),
        ("flash_dkv", "dkv", f"{tpu}:242 (_dkv_kernel_fullt) and {tpu}:175 (_dkv_kernel)",
         ("dk_split", "dv_split")),
        ("flash_so", "so", f"{tpu}:969", ("c_q", "c_k", "c_v", "c_dO")),
        ("flash_so_row", "so_row", f"{tpu}:791", ("c_q_row", "c_dO_row", "g_D", "s_gp")),
        ("flash_so_col", "so_col", f"{tpu}:867", ("c_k_col", "c_v_col")),
        ("dropout_mask", "mask", f"{tpu}:640", ("mask",)),
    ):
        top = kres[("fusion", "mask")] if key == "mask" else kres[("fusion", torch.bfloat16, 0.0)]
        per_shape = []
        for name, *_ in SHAPES:
            if key != "mask" and key not in SHAPE_KERNELS.get(name, REDESIGNED):
                continue
            for rate in ((RATE,) if key == "mask" else (0.0, RATE)):
                r = kres[(name, "mask")] if key == "mask" else kres[(name, torch.bfloat16, rate)]
                per_shape.append({"shape": name, "rate": rate, "ms": r[f"{key}_ms"],
                                  "plain_ms": r[f"{key}_plain_ms"],
                                  "library_ms": r.get(f"{key}_library_ms"),
                                  "bound_ms": r[f"{key}_bound_ms"],
                                  "bound_by": r[f"{key}_bound_by"]})
        if key == "mask":
            r = kres[("module", "mask")]
            per_shape.append({"shape": f"module dropout {r['region']}", "rate": RATE,
                              **{k: r[f"mask_{k}"] for k in ("ms", "plain_ms", "library_ms",
                                                              "bound_ms", "bound_by")}})
        by_path = {p: c[kname] for p, c in paths.items()}
        kernels.append({
            "name": kname, "route": "cuda", "source": f"interactron_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(top["errs"][k] for k in errs),
            "ms": top[f"{key}_ms"], "plain_ms": top[f"{key}_plain_ms"],
            "bound_ms": top[f"{key}_bound_ms"], "bound_by": top[f"{key}_bound_by"],
            "library_ms": top.get(f"{key}_library_ms"), "library": library.get(key),
            "at": f"{at}, rate 0.1 mask of (8, 2060, 2060)" if key == "mask" else f"{at}, rate 0",
            "per_shape": per_shape,
        })
        if key in REDESIGNED:
            kernels[-1].update(redesigned="bf16 on wgmma and TMA", host_ms=top[f"{key}_host_ms"])
        elif key == "mask":
            kernels[-1].update(redesigned="16-byte stores, no 64-bit index math",
                               host_ms=top["mask_host_ms"])
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)  # nvidia-smi's name and power limit, on a line of its own
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
