#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (interactron_tpu_torch) on one NVIDIA GPU and
check it end to end.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no "ok" line):
  1. device line (nvidia-smi name and power limit); TF32 off for fp32 work;
  2. build every CUDA kernel of the path from interactron_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version at the path's shapes, in
     fp32 and bf16, with its time beside the plain version's, one PyTorch
     library call's (F.scaled_dot_product_attention, a yardstick only) and
     the bound max(FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s);
  4. full-width fp32 `predict` of configs/interactron.yaml (seed 0): the card
     against the CPU, which runs the plain versions;
  5. the served path in bf16: 4 episodes of next_action at s=1..4 and then
     predict, in the evaluator's order, with the kernel launch counters
     checked against the counts the path must make;
  6. device time by kernel over one bf16 predict (torch.profiler).
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


def bounds(b, t, s, h, d, elt):
    """Least times (ms) of the forward and of the merged backward."""
    qo, kv, rows = b * t * h * d, b * s * h * d, b * h * t
    fwd_flops = 4.0 * b * h * t * s * d
    fwd_bytes = (2 * qo + 2 * kv) * elt + rows * 4
    bwd_flops = 2.5 * fwd_flops
    bwd_bytes = (4 * qo + 4 * kv) * elt + rows * 4  # in: q k v O dO L; out: dq dk dv
    ms = lambda f, n: 1e3 * max(f / PEAK_FLOPS, n / PEAK_BYTES)
    by = lambda f, n: "operations" if f / PEAK_FLOPS >= n / PEAK_BYTES else "bytes"
    return ((ms(fwd_flops, fwd_bytes), by(fwd_flops, fwd_bytes)),
            (ms(bwd_flops, bwd_bytes), by(bwd_flops, bwd_bytes)))


def check_kernels(fa):
    """Phase 3: kernel vs plain on the card at the path's shapes."""
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, t, s, h, d in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            mk = lambda n: torch.randn((b, n, h * d), device="cuda", generator=gen).to(dtype)
            q, k, v, do = mk(t), mk(s), mk(s), mk(t)
            q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
            o_ref, lse_ref = fa.flash_fwd_plain(q32, k32, v32, h)
            dq_ref, dk_ref, dv_ref = fa.flash_bwd_plain(q32, k32, v32, o_ref, lse_ref, do32, h)
            o, lse = fa.flash_fwd(q, k, v, h)
            qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
            og = fa.FlashAttention.apply(qg, kg, vg, h)
            og.backward(do)
            torch.cuda.synchronize()
            rel, why = TOL[dtype]
            errs = {}
            for key, got, ref in (("O", o, o_ref), ("O_autograd", og, o_ref), ("L", lse, lse_ref),
                                  ("dq", qg.grad, dq_ref), ("dk", kg.grad, dk_ref),
                                  ("dv", vg.grad, dv_ref)):
                err = (got.float() - ref).abs().max().item()
                tol = rel * ref.abs().max().item()
                errs[key] = err
                log(f"  {name:12s} {str(dtype)[6:]:8s} {key:10s} max_abs_err={err:.3e} "
                    f"tol={tol:.3e} ({rel:g} x max|ref|: {why})")
                if not err <= tol:
                    raise AssertionError(f"{name} {dtype} {key}: {err} > {tol}")
            entry = {"errs": errs}
            if dtype == torch.bfloat16:
                entry["fwd_ms"] = cuda_ms(lambda: fa.flash_fwd(q, k, v, h))
                entry["bwd_ms"] = cuda_ms(lambda: fa.flash_bwd(q, k, v, o, lse, do, h))
                entry["fwd_plain_ms"] = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, h))
                entry["bwd_plain_ms"] = cuda_ms(
                    lambda: fa.flash_bwd_plain(q, k, v, o, lse, do, h))
                heads = lambda x, n: x.view(b, n, h, d).transpose(1, 2)
                qh, kh, vh = heads(q, t), heads(k, s), heads(v, s)
                entry["fwd_library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh))
                ql, kl, vl = (x.detach().clone().requires_grad_(True) for x in (qh, kh, vh))
                ol = F.scaled_dot_product_attention(ql, kl, vl)
                doh = heads(do, t)
                entry["bwd_library_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(ol, (ql, kl, vl), doh, retain_graph=True))
                (fb, fby), (bb, bby) = bounds(b, t, s, h, d, 2)
                entry.update(fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb, bwd_bound_by=bby)
                log(f"  {name:12s} bf16 times (ms): fwd {entry['fwd_ms']:.4f} plain "
                    f"{entry['fwd_plain_ms']:.4f} sdpa {entry['fwd_library_ms']:.4f} bound "
                    f"{fb:.4f} ({fby}) | bwd {entry['bwd_ms']:.4f} plain "
                    f"{entry['bwd_plain_ms']:.4f} sdpa {entry['bwd_library_ms']:.4f} bound "
                    f"{bb:.4f} ({bby})")
            results[(name, dtype)] = entry
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
    return {"flash_fwd": fwd, "flash_bwd": enc + 4}


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


def profile_predict(model, C):
    """Device time by kernel over one predict, and the device's idle share
    (1 - summed kernel time / wall time; overlapping kernels would count
    twice, and this path launches on one stream)."""
    from torch.profiler import ProfilerActivity, profile

    frames = synthetic_frames(200)
    model.predict({"frames": frames})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.predict({"frames": frames})
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
    groups = {"attention kernels (flash_fwd/flash_bwd)": ("fwd_kernel", "bwd_kernel"),
              "convolution (cuDNN and friends)": ("conv", "cudnn", "implicit", "xmma", "sm90_",
                                                  "wgrad", "dgrad", "fprop")}
    for gname, keys in groups.items():
        t = sum(v[1] for n, v in by_name.items() if any(k in n.lower() for k in keys))
        log(f"  {gname}: {t:.2f} ms")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {t:8.3f} ms {n:5d}x {name[:110]}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
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
    profile_predict(model, C)

    top = kres[("fusion", torch.bfloat16)]
    kernels = []
    for kname, key, src, replaces in (
        ("flash_fwd", "fwd", "interactron_tpu_torch/csrc/flash_fwd.cu",
         "interactron_tpu/ops/flash_attention.py:92"),
        ("flash_bwd", "bwd", "interactron_tpu_torch/csrc/flash_bwd.cu",
         "interactron_tpu/ops/flash_attention.py:299"),
    ):
        errs = top["errs"]
        err = errs["O"] if key == "fwd" else max(errs["dq"], errs["dk"], errs["dv"])
        per_shape = []
        for name, *_ in SHAPES:
            r = kres[(name, torch.bfloat16)]
            per_shape.append({"shape": name, "ms": r[f"{key}_ms"], "plain_ms": r[f"{key}_plain_ms"],
                              "library_ms": r[f"{key}_library_ms"],
                              "bound_ms": r[f"{key}_bound_ms"]})
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[kname], "max_abs_err": err, "ms": top[f"{key}_ms"],
            "plain_ms": top[f"{key}_plain_ms"], "bound_ms": top[f"{key}_bound_ms"],
            "bound_by": top[f"{key}_bound_by"], "library_ms": top[f"{key}_library_ms"],
            "at": "fusion B=1 T=S=2060 H=8 D=64 bf16", "per_shape": per_shape,
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
