#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (interactron_tpu_torch) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no "ok" line):
  1. device line (nvidia-smi name and power limit); TF32 off for fp32 work;
  2. build every CUDA kernel of the paths from interactron_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version at the paths' shapes, in
     fp32 and bf16, at dropout rate 0 and 0.1 (the mask kernel bit for bit),
     with its time beside the plain version's, one PyTorch library call's
     where one computes the same function (F.scaled_dot_product_attention, a
     yardstick only) and the bound (see `bound_ms`);
  4. full-width fp32 `predict` of configs/interactron.yaml (seed 0): the card
     against the CPU, which runs the plain versions;
  5. the served path in bf16: 4 episodes of next_action at s=1..4 and then
     predict, in the evaluator's order, with the kernel launch counters
     checked against the counts the path must make;
  6. device time by kernel over one bf16 predict (torch.profiler);
  7. one full-width fp32 episode of the second-order meta-train step
     (`grads_and_metrics`, dropout on): the card against the CPU;
  8. bf16 training: 3 optimizer steps of 4 episodes (the config's batch of
     16 cut to 4 for time), dropout at the config's rates, with the launch
     counters checked against the counts the train path must make;
  9. device time by kernel over one bf16 train step (torch.profiler).
Prints the kernels' JSON line, then {"ok": true, "device": {...}} last.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
# 32-bit integer instructions/s of the CUDA cores: 132 SMs x 64 INT32 lanes
# x 1.98 GHz (half the FP32 lanes behind the 67 TFLOP/s fp32 peak, one op
# a lane per clock instead of an FMA's two)
PEAK_INT_OPS = 16.7e12
HASH_OPS = 12  # integer ops of one keep bit (csrc/dropout.cuh: mul, fmix32, compare)
RATE = 0.1  # the config's attention and residual dropout
SEED = 4321
# (name, B, T, S, H, D) of every attention the kernels serve on the path
SHAPES = [
    ("encoder_b5", 5, 361, 361, 8, 32),
    ("fusion", 1, 2060, 2060, 8, 64),
    ("fusion_last", 1, 255, 2060, 8, 64),
]
# max abs error allowed, as a multiple of the reference's max abs value
TOL = {
    torch.float32: (1e-4, "fp32 in and out: summation order, exp2f of pre-scaled logits, "
                          "and dQ atomics in no fixed order"),
    torch.bfloat16: (2e-2, "outputs rounded to bf16 (2^-8 relative), P rounded to bf16 before "
                           "P.V and dV, dS before dK and dQ; reference is fp32 on the same "
                           "bf16 inputs"),
}
EPISODES = 4


def log(*a):
    print(*a, flush=True)


def device_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes, int_ops=0.0):
    """(least time in ms, "operations" or "bytes"): the larger of the bytes
    over HBM's rate and the operations over the peak of their type (bf16
    tensor-core FLOPs, 32-bit integer ops of the dropout hash)."""
    ops_s = max(flops / PEAK_FLOPS, int_ops / PEAK_INT_OPS)
    bytes_s = nbytes / PEAK_BYTES
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def bounds(b, t, s, h, d, elt, rate=0.0):
    """Least times (ms, by) of the forward, the merged backward and the
    second-order kernel; with dropout each needs one keep bit per (T, S)
    element of every head."""
    qo, kv, rows = b * t * h * d, b * s * h * d, b * h * t
    hash_ops = HASH_OPS * b * h * t * s if rate > 0 else 0.0
    fwd_flops = 4.0 * b * h * t * s * d
    return {
        "fwd": bound_ms(fwd_flops, (2 * qo + 2 * kv) * elt + rows * 4, hash_ops),
        # in: q k v O dO L; out: dq dk dv
        "bwd": bound_ms(2.5 * fwd_flops, (4 * qo + 4 * kv) * elt + rows * 4, hash_ops),
        # twelve T x S x D products; in: q dO A k v Bc C L D, out: c_q c_dO c_k c_v
        "so": bound_ms(24.0 * b * h * t * s * d, (5 * qo + 6 * kv) * elt + 2 * rows * 4,
                       hash_ops),
    }


def mask_bound(n):
    """Least time of the mask kernel: one byte written per element, and the
    hash's integer ops."""
    return bound_ms(0.0, n, HASH_OPS * n)


def _check_errs(label, pairs, rel, why):
    errs = {}
    for key, got, ref in pairs:
        err = (got.float() - ref).abs().max().item()
        tol = rel * ref.abs().max().item()
        errs[key] = err
        log(f"  {label} {key:10s} max_abs_err={err:.3e} tol={tol:.3e} ({rel:g} x max|ref|: {why})")
        if not err <= tol:
            raise AssertionError(f"{label} {key}: {err} > {tol}")
    return errs


def check_kernels(fa):
    """Phase 3: kernel vs plain on the card at the paths' shapes. Returns
    {(shape, dtype, rate): entry} with the errors, and in bf16 the times."""
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, t, s, h, d in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            mk = lambda n: torch.randn((b, n, h * d), device="cuda", generator=gen).to(dtype)
            q, k, v, do, a, bc, c = mk(t), mk(s), mk(s), mk(t), mk(t), mk(s), mk(s)
            f32 = [x.float() for x in (q, k, v, do, a, bc, c)]
            rel, why = TOL[dtype]
            for rate in (0.0, RATE):
                seed = SEED if rate else 0
                drop = (rate, seed)
                o_ref, lse_ref = fa.flash_fwd_plain(*f32[:3], h, *drop)
                delta_ref = fa._delta(f32[3], o_ref, h)
                bwd_ref = fa.flash_bwd_plain(*f32[:3], o_ref, lse_ref, f32[3], h, *drop)
                so_ref = fa.flash_so_plain(*f32, lse_ref, delta_ref, h, *drop)
                o, lse = fa.flash_fwd(q, k, v, h, *drop)
                bwd = fa.flash_bwd(q, k, v, o, lse, do, h, *drop)
                # the second-order kernel on the plain version's L and D, so
                # that its check is of it alone
                so = fa.flash_so(q, k, v, do, a, bc, c, lse_ref, delta_ref, h, *drop)
                qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
                og = fa.FlashAttention.apply(qg, kg, vg, h, *drop)
                og.backward(do)
                torch.cuda.synchronize()
                label = f"{name:12s} {str(dtype)[6:]:8s} rate {rate:g}"
                errs = _check_errs(label, (
                    ("O", o, o_ref), ("O_autograd", og, o_ref), ("L", lse, lse_ref),
                    ("dq", bwd[0], bwd_ref[0]), ("dk", bwd[1], bwd_ref[1]),
                    ("dv", bwd[2], bwd_ref[2]), ("dq_autograd", qg.grad, bwd_ref[0]),
                    ("c_q", so[0], so_ref[0]), ("c_k", so[1], so_ref[1]),
                    ("c_v", so[2], so_ref[2]), ("c_dO", so[3], so_ref[3])), rel, why)
                entry = {"errs": errs}
                if dtype == torch.bfloat16:
                    entry.update(
                        fwd_ms=cuda_ms(lambda: fa.flash_fwd(q, k, v, h, *drop)),
                        fwd_plain_ms=cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, h, *drop)),
                        bwd_ms=cuda_ms(lambda: fa.flash_bwd(q, k, v, o, lse, do, h, *drop)),
                        bwd_plain_ms=cuda_ms(
                            lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, h, *drop)),
                        so_ms=cuda_ms(lambda: fa.flash_so(q, k, v, do, a, bc, c, lse, delta_ref,
                                                          h, *drop)),
                        so_plain_ms=cuda_ms(lambda: fa.flash_so_plain(
                            q, k, v, do, a, bc, c, lse, delta_ref, h, *drop)),
                        so_library_ms=None)
                    if rate == 0.0:
                        # SDPA has no dropout mask of ours and no double backward
                        heads = lambda x, n: x.view(b, n, h, d).transpose(1, 2)
                        qh, kh, vh = heads(q, t), heads(k, s), heads(v, s)
                        entry["fwd_library_ms"] = cuda_ms(
                            lambda: F.scaled_dot_product_attention(qh, kh, vh))
                        ql, kl, vl = (x.detach().clone().requires_grad_(True)
                                      for x in (qh, kh, vh))
                        ol = F.scaled_dot_product_attention(ql, kl, vl)
                        doh = heads(do, t)
                        entry["bwd_library_ms"] = cuda_ms(
                            lambda: torch.autograd.grad(ol, (ql, kl, vl), doh, retain_graph=True))
                    for kname, (bms, by) in bounds(b, t, s, h, d, 2, rate).items():
                        entry[f"{kname}_bound_ms"], entry[f"{kname}_bound_by"] = bms, by
                    log(f"  {label} times (ms): " + " | ".join(
                        f"{kn} {entry[kn + '_ms']:.4f} plain {entry[kn + '_plain_ms']:.4f} "
                        f"lib {entry.get(kn + '_library_ms') or float('nan'):.4f} bound "
                        f"{entry[kn + '_bound_ms']:.4f} ({entry[kn + '_bound_by']})"
                        for kn in ("fwd", "bwd", "so")))
                results[(name, dtype, rate)] = entry

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
        log(f"  {name:12s} mask {region}: bit-exact {same}, keep fraction {keep:.6f} "
            f"(1 - rate = {1 - RATE:g}, sigma {sigma:.1e}); ms {entry['mask_ms']:.4f} plain "
            f"{entry['mask_plain_ms']:.4f} bound {mb:.4f} ({mby})")
        if not same or abs(keep - (1 - RATE)) > 6 * sigma:
            raise AssertionError(f"{name} dropout mask: bit-exact {same}, keep {keep}")
        results[(name, "mask")] = entry
    return results


def synthetic_frames(seed, s=5, size=300):
    """ImageNet-normalised (1, s, size, size, 3) float32 frames."""
    rng = np.random.RandomState(seed)
    img = rng.rand(1, s, size, size, 3).astype(np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    return (img - mean) / std


def calibrated_weights(config_dict, Task, Config):
    """Seed-0 random weights with every FrozenBatchNorm's statistics set to
    those of its input on a seeded calibration batch, as pretrained
    statistics would be. With identity statistics the random ResNet's
    activations grow through the trunk until the DETR encoder's first fp32
    logits, and the gradients through them, are too ill-conditioned for a
    card vs CPU comparison to mean anything."""
    from interactron_tpu_torch.models.layers import FrozenBatchNorm

    cfg = json.loads(json.dumps(config_dict))
    cfg["MODEL"]["DTYPE"] = "float32"
    model = Task(Config(cfg), device="cpu").init(0)

    def set_stats(mod, args):
        x = args[0].float()
        mod.running_mean.copy_(x.mean((0, 2, 3)))
        mod.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, FrozenBatchNorm)]
    with torch.no_grad():
        model.detector(model.frames({"frames": synthetic_frames(0)})[0])
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
    ep = {"frames": synthetic_frames(1)}
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


def expected_launches(C):
    """Kernel launches of one episode of next_action at s=1..4 + predict, read
    from the gates of ops/attention.py (hd>=32, s>=256, t>=128)."""
    enc = 6  # DETR encoder layers: t=s=361
    fwd = 0
    for s in range(1, C.NUM_FRAMES):
        # 3 full fusion blocks, and the last (pruned to s*50+5 queries) from s=3
        fwd += enc + 3 + (1 if s * C.NUM_QUERIES + C.NUM_FRAMES >= 128 else 0)
    fwd += enc + 4 + enc  # predict: inner forward, then the frame-0 detect
    return {"flash_fwd": fwd, "flash_bwd": enc + 4, "flash_so": 0, "dropout_mask": 0}


def served_path(model, fa, C, episodes=EPISODES):
    """Phase 5: the lockstep evaluator's order, one episode at a time."""
    fa.reset_launches()
    na_ms, pr_ms = [], []
    for e in range(episodes):
        frames = synthetic_frames(100 + e)
        for s in range(1, C.NUM_FRAMES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a = int(model.next_action({"frames": frames[:, :s]}))
            na_ms.append(1e3 * (time.perf_counter() - t0))
            if not 0 <= a < C.NUM_ACTIONS:
                raise AssertionError(f"action {a} out of range")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = model.predict({"frames": frames})
        torch.cuda.synchronize()
        pr_ms.append(1e3 * (time.perf_counter() - t0))
        nc = model.config.MODEL.NUM_CLASSES + 1
        want = {"pred_logits": (1, 1, C.NUM_QUERIES, nc), "pred_boxes": (1, 1, C.NUM_QUERIES, 4)}
        for key, shape in want.items():
            if tuple(pred[key].shape) != shape or not torch.isfinite(pred[key]).all():
                raise AssertionError(f"{key}: shape {tuple(pred[key].shape)} or non-finite")
    counts = dict(fa.launches)
    want = {k: n * episodes for k, n in expected_launches(C).items()}
    log(f"  launches on the served path: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return counts, na_ms, pr_ms


def profile_run(fn):
    """Device time by kernel over one call of `fn` (after a warm-up call),
    and the device's idle share (1 - summed kernel time / wall time;
    overlapping kernels would count twice, and these paths launch on one
    stream)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy = sum(t for _, t in by_name.values())
    log(f"  wall {wall_ms:.2f} ms, device kernels {busy:.2f} ms in {len(kernels)} launches, "
        f"idle share {1 - busy / wall_ms:.3f} (profiler on)")
    groups = {"flash_fwd (fwd_kernel)": ("fwd_kernel",), "flash_bwd (bwd_kernel)": ("bwd_kernel",),
              "flash_so (so_kernel)": ("so_kernel",), "dropout_mask (mask_kernel)": ("mask_kernel",),
              "convolution (cuDNN and friends)": ("conv", "cudnn", "implicit", "xmma", "sm90_",
                                                  "wgrad", "dgrad", "fprop")}
    for gname, keys in groups.items():
        hits = [v for n, v in by_name.items() if any(k in n.lower() for k in keys)]
        log(f"  {gname}: {sum(v[1] for v in hits):.2f} ms in {sum(v[0] for v in hits)} launches")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"  {t:8.3f} ms {n:5d}x {name[:110]}")


def synthetic_batch(seed, episodes, num_classes, C):
    """A batch of `episodes` seeded episodes in the train step's layout:
    frames (b, 5, 300, 300, 3), 1-10 valid boxes per frame of C.MAX_BOXES."""
    rng = np.random.RandomState(seed)
    shape = (episodes, C.NUM_FRAMES, C.MAX_BOXES)
    valid = np.arange(C.MAX_BOXES) < rng.randint(1, 11, shape[:2])[..., None]
    boxes = np.concatenate([rng.uniform(0.2, 0.8, shape + (2,)),
                            rng.uniform(0.05, 0.4, shape + (2,))], -1)
    return {
        "frames": np.concatenate([synthetic_frames(seed * 100 + e) for e in range(episodes)]),
        "actions": rng.randint(0, C.NUM_ACTIONS, shape[:2]).astype(np.int64),
        "labels": (rng.randint(0, num_classes, shape) * valid).astype(np.int64),
        "boxes": (boxes * valid[..., None]).astype(np.float32),
        "valid": valid,
        "episode_uid": np.arange(episodes, dtype=np.int64),
    }


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


def train_parity(config_dict, Task, Config, weights, C):
    """Phase 7: one fp32 episode of the meta-train step with dropout on, the
    card against the CPU. The keep bits are a hash of seeds drawn from one
    CPU generator, so both devices drop the same elements. As in phase 4,
    the gradients are held against the CPU's own change when the frames move
    by 1e-6 relative, and so are the losses, which go through the
    fast weights; the count-like metrics are printed. The full step's
    gradient is discontinuous at that scale (clip boundaries, matching,
    ReLU masks), so the second-order term is also held alone
    (`second_order_probe`)."""
    cfg = json.loads(json.dumps(config_dict))
    cfg["MODEL"]["DTYPE"] = "float32"
    batch = synthetic_batch(7, 1, cfg["MODEL"]["NUM_CLASSES"], C)
    noise = np.random.RandomState(2).randn(*batch["frames"].shape).astype(np.float32)
    moved = dict(batch, frames=batch["frames"] * (1 + 1e-6 * noise))
    res = {}
    for dev in ("cpu", "cuda"):
        model = Task(Config(cfg), device=dev).load_weights(weights)
        runs = [("base", batch)] + ([("moved", moved)] if dev == "cpu" else [])
        for key, b in runs:
            res[(dev, key, "probe")] = second_order_probe(model, b["frames"][0:1])
            t0 = time.perf_counter()
            g, m, _ = model.grads_and_metrics(b, torch.Generator().manual_seed(11),
                                              model.init_path_state(4), train=True,
                                              frame_index=[2])
            if dev == "cuda":
                torch.cuda.synchronize()
            log(f"  {dev} {key}: {time.perf_counter() - t0:.1f} s")
            res[(dev, key)] = ({grp: {n: x.cpu() for n, x in d.items()} for grp, d in g.items()}, m)
        del model
    (gc, mc), (gr, mr), (gm, mm) = res[("cuda", "base")], res[("cpu", "base")], res[("cpu", "moved")]
    norm = lambda d: sum(torch.sum(x.double() ** 2) for x in d.values()).sqrt().item()
    pc, pr, pm = (res[(dev, key, "probe")] for dev, key in
                  (("cuda", "base"), ("cpu", "base"), ("cpu", "moved")))
    for label, c, r, mv in (("detector gradient", gc["detector"], gr["detector"], gm["detector"]),
                            ("fusion gradient", gc["fusion"], gr["fusion"], gm["fusion"]),
                            ("second-order probe (fusion)", pc, pr, pm)):
        err = norm({n: c[n] - r[n] for n in r}) / norm(r)
        sens = norm({n: mv[n] - r[n] for n in r}) / norm(r)
        log(f"  fp32 train step card vs CPU: {label} ||card - cpu|| / ||cpu|| = {err:.3e} "
            f"tol={10 * sens:.3e} (10 x the CPU's own change, {sens:.3e}, when the frames move "
            f"by 1e-6 relative); norms card {norm(c):.6e} CPU {norm(r):.6e}")
        if not err <= 10 * sens:
            raise AssertionError(f"train step {label}: {err} > {10 * sens}")
    for k in mr:
        err, sens = abs(mc[k] - mr[k]), abs(mm[k] - mr[k])
        tol = max(1e-4 * abs(mr[k]), 10 * sens)
        held = "loss" in k or k == "policy_reward"
        log(f"  fp32 train step metric {k}: card {mc[k]:.6f} CPU {mr[k]:.6f} err={err:.3e} "
            + (f"tol={tol:.3e} (max of 1e-4 x |CPU| and 10 x the CPU's own change)" if held
               else "(count-like, printed only)"))
        if held and not err <= tol:
            raise AssertionError(f"train step metric {k}: {err} > {tol}")


def expected_train_launches(m):
    """Kernel launches of one train episode, read from the gates of
    ops/attention.py. The inner closure's attentions past the second-order
    gates (the DETR encoder's and every fusion block's; the decoder's 50
    queries stay dense) take FlashAttentionSO: its forward, the g pass's
    FlashGrads forward (forward recompute + backward), and in the outer
    backward its own backward again (FlashGrads forward) and FlashGrads'
    backward (forward recompute + second-order kernel). The supervisor and
    detector passes take the first-order kernels in the encoder. Every
    dropout outside the fused kernels draws one mask: per DETR pass 3 a
    encoder layer, 4 + 2 attention masks a decoder layer; per fusion pass
    the embedding's and 2 a block."""
    enc, dec = int(m.get("NUM_ENCODER_LAYERS", 6)), int(m.get("NUM_DECODER_LAYERS", 6))
    inner = enc + int(m.NUM_LAYERS)
    return {"flash_fwd": 4 * inner + 2 * enc, "flash_bwd": 2 * inner + 2 * enc,
            "flash_so": inner, "dropout_mask": 3 * (3 * enc + 6 * dec) + 1 + 2 * int(m.NUM_LAYERS)}


def train_bf16(model, fa, C, Trainer, steps=3, episodes=4):
    """Phase 8: `steps` optimizer steps of `episodes` episodes in bf16 with
    dropout on. Returns (launch counts, ms per step, the profile batch)."""
    cfg = model.config
    trainer = Trainer(model, cfg, path_rows=64)
    gen = torch.Generator().manual_seed(0)
    batches = [synthetic_batch(20 + i, episodes, cfg.MODEL.NUM_CLASSES, C) for i in range(steps)]
    before = {grp: [p.detach().clone() for p in mod.parameters()]
              for grp, mod in (("detector", model.detector), ("fusion", model.fusion))}
    fa.reset_launches()
    step_ms = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(batch, gen)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        log(f"  step {i}: {step_ms[-1]:.1f} ms, total_loss {metrics['total_loss']:.4f}, "
            f"grad_norm {metrics['grad_norm']:.4e}, policy_reward {metrics['policy_reward']:.4f}")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite metrics at step {i}: {metrics}")
    counts = dict(fa.launches)
    want = {k: n * steps * episodes for k, n in expected_train_launches(cfg.MODEL).items()}
    log(f"  launches on the train path: {counts} (expected {want})")
    if counts != want:
        raise AssertionError(f"train launch counts {counts} != {want}")
    for grp, mod in (("detector", model.detector), ("fusion", model.fusion)):
        moved = sum(int(not torch.equal(p, q)) for p, q in zip(mod.parameters(), before[grp]))
        log(f"  {grp}: {moved} of {len(before[grp])} parameter tensors moved")
        if moved == 0:
            raise AssertionError(f"no {grp} parameter moved")
    return counts, step_ms, trainer, batches[0]


def main():
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

    t_start = time.perf_counter()
    card = device_line()
    log(f"[1] device: {card}")
    log(f"    torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = cuda_build.build_all()
    log(f"[2] built {sorted(reports) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    log("[3] kernels vs plain versions")
    kres = check_kernels(fa)

    log("[4] full-width fp32 predict, card vs CPU")
    cfg_dict = get_config("configs/interactron.yaml").to_dict()
    weights = calibrated_weights(cfg_dict, InteractronTask, Config)
    full_width_parity(cfg_dict, InteractronTask, Config, weights)

    log("[5] served path in bf16: next_action x4 + predict per episode")
    model = InteractronTask(Config(cfg_dict), device="cuda").load_weights(weights)
    counts, na_ms, pr_ms = served_path(model, fa, C)
    steady = pr_ms[1:]
    log(f"  predict: {1e3 / np.mean(steady):.3f} episodes/s (mean of {len(steady)} episodes "
        f"after the first, {np.mean(steady):.2f} ms each; first {pr_ms[0]:.1f} ms); "
        f"next_action: median {np.median(na_ms[4:]):.2f} ms over {len(na_ms) - 4} calls after "
        f"the first episode; card: {card}")

    log("[6] where the time goes: one bf16 predict episode under torch.profiler")
    frames = synthetic_frames(200)
    profile_run(lambda: model.predict({"frames": frames}))
    del model

    log("[7] full-width fp32 train step (one episode, dropout on), card vs CPU")
    train_parity(cfg_dict, InteractronTask, Config, weights, C)

    log(f"[8] bf16 training: 3 steps of 4 episodes (config BATCH_SIZE "
        f"{cfg_dict['TRAINER']['BATCH_SIZE']} cut to 4 for time), dropout on")
    model = InteractronTask(Config(cfg_dict), device="cuda").load_weights(weights)
    train_counts, step_ms, trainer, batch = train_bf16(model, fa, C, Trainer)
    steady = step_ms[1:]
    log(f"  train: {4e3 / np.mean(steady):.3f} episodes/s, {np.mean(steady):.1f} ms per step of 4 "
        f"episodes (mean of {len(steady)} steps after the first, {step_ms[0]:.1f} ms); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {card}")

    log("[9] where the time goes: one bf16 train step of 4 episodes under torch.profiler")
    gen = torch.Generator().manual_seed(1)
    profile_run(lambda: trainer.train_step(batch, gen))

    kernels = []
    at = "fusion B=1 T=S=2060 H=8 D=64 bf16"
    for kname, key, src, replaces in (
        ("flash_fwd", "fwd", "interactron_tpu_torch/csrc/flash_fwd.cu",
         "interactron_tpu/ops/flash_attention.py:92"),
        ("flash_bwd", "bwd", "interactron_tpu_torch/csrc/flash_bwd.cu",
         "interactron_tpu/ops/flash_attention.py:299"),
        ("flash_so", "so", "interactron_tpu_torch/csrc/flash_so.cu",
         "interactron_tpu/ops/flash_attention.py:969"),
        ("dropout_mask", "mask", "interactron_tpu_torch/csrc/dropout_mask.cu",
         "interactron_tpu/ops/flash_attention.py:640"),
    ):
        errs = {"fwd": ("O", "L"), "bwd": ("dq", "dk", "dv"), "so": ("c_q", "c_k", "c_v", "c_dO"),
                "mask": ("mask",)}[key]
        top = kres[("fusion", "mask")] if key == "mask" else kres[("fusion", torch.bfloat16, 0.0)]
        per_shape = []
        for name, *_ in SHAPES:
            for rate in ((RATE,) if key == "mask" else (0.0, RATE)):
                r = kres[(name, "mask")] if key == "mask" else kres[(name, torch.bfloat16, rate)]
                per_shape.append({"shape": name, "rate": rate, "ms": r[f"{key}_ms"],
                                  "plain_ms": r[f"{key}_plain_ms"],
                                  "library_ms": r.get(f"{key}_library_ms"),
                                  "bound_ms": r[f"{key}_bound_ms"],
                                  "bound_by": r[f"{key}_bound_by"]})
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[kname] + train_counts[kname],
            "launches_by_path": {"served": counts[kname], "train": train_counts[kname]},
            "max_abs_err": max(top["errs"][k] for k in errs),
            "ms": top[f"{key}_ms"], "plain_ms": top[f"{key}_plain_ms"],
            "bound_ms": top[f"{key}_bound_ms"], "bound_by": top[f"{key}_bound_by"],
            "library_ms": top.get(f"{key}_library_ms"),
            "at": f"{at}, rate 0.1 mask of (8, 2060, 2060)" if key == "mask" else f"{at}, rate 0",
            "per_shape": per_shape,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)  # nvidia-smi's name and power limit, on a line of its own
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
