"""Served-episode traffic: closed-loop agents in chunks of `chunk` episodes
(1: one agent at a time, as the reference's evaluator and a deployed agent
run it; more: `InteractiveEvaluator._evaluate_lockstep`'s order).

Traffic parameters: `chunk`, a pool of `episodes` episodes of `states`
states each (portbench/lib/frames.py, drawn from the seed, ImageNet-
normalised numpy frames in memory, at most `max_det` boxes a frame), cycled
in a seeded order; `stretch_chunks` chunks are profiled in a traced run;
`check_episodes` of the window's first `check_within` episodes, drawn from
the seed, are judged against the reference.

An episode is `next_action` at s = 1..4, each next frame picked by the
returned action from the episode's state grid, then the adaptive
`predict` on the five frames, its predictions fetched to the host. The
window runs whole chunks until `--seconds` have passed: `served_eps` is
their episodes over the time from the first chunk's start to the last
chunk's end, and an episode's latency is its chunk's.
"""

import gc
import time

import numpy as np
import torch

from portbench.lib import compare, frames, weights
from portbench.lib.precision import fp32
from portbench.reference import constants as C
from portbench.reference.config import Config as RefConfig
from portbench.reference.meta import split_inner
from portbench.reference.task import ReferenceTask

WARM_CHUNKS = 2


def prepare(run):
    """The inputs both sides get: the weights (made by the benchmark on the
    device from the seed), the state grids and the episodes' order."""
    tr = run.traffic
    cfg = run.model_config
    size = int(cfg["MODEL"]["TEST_RESOLUTION"])
    ref = ReferenceTask(RefConfig(cfg), run.device)
    run.weights = {k: v.cpu() for k, v in weights.make(ref, run.seed, size).items()}
    del ref
    run.grid = frames.state_grid(run.seed, tr["episodes"], tr["states"], size, tr["max_det"],
                                 tr["categories"])
    run.next_state = frames.successors(tr["states"], C.NUM_ACTIONS)
    rng = np.random.RandomState(run.seed % 2**32)
    order = np.concatenate([rng.permutation(tr["episodes"]) for _ in range(64)])
    run.order = iter(order.tolist())
    run.buf = np.empty((tr["chunk"], C.NUM_FRAMES, size, size, 3), np.float32)


def setup(run):
    from interactron_tpu_torch.utils.config import Config, build_model

    prepare(run)
    task = build_model(Config(run.model_config), device=run.device)
    task.load_state_dict(run.weights)
    run.objects["task"] = task
    if run.fault == "fast_unstepped":
        adapt = task.adapt

        def unstepped(episodes):
            fast, g, prefix = adapt(episodes)
            params = dict(task.detector.named_parameters())
            return ({k: (params[k].to(v.dtype).expand_as(v) if k in g else v)
                     for k, v in fast.items()}, g, prefix)

        task.adapt = unstepped
    _capture(run, task)
    if run.fault == "answer_altered":
        predict = task.predict

        def altered(episodes):
            out = predict(episodes)
            out["pred_boxes"] = out["pred_boxes"] + 0.25
            return out

        task.predict = altered
    for _ in range(WARM_CHUNKS):
        _chunk(run)


def _capture(run, task):
    """Keep, on the device, what the program derived for the checked
    episodes: the action logits each next_action call took its argmax of
    (the fusion's output inside the call), and the inner gradients and fast
    weights of predict's adapt. The checked episodes are drawn from the
    seed among the window's first `check_within` before it starts
    (`run.checked`, ordinals of the window's episodes)."""
    tr = run.traffic
    rng = np.random.RandomState((run.seed + 1) % 2**32)
    run.checked = set(rng.choice(tr["check_within"], tr["check_episodes"], replace=False).tolist())
    run.capture_rows, run.captured, run.action_logits = [], {}, []
    adapt, next_action, fusion_apply = task.adapt, task.next_action, task.fusion_apply
    inside = []

    def fusion_kept(*a, **kw):
        out = fusion_apply(*a, **kw)
        if inside and run.capture_rows:
            run.action_logits.append(out["actions"].detach())
        return out

    def next_action_kept(episodes):
        inside.append(True)
        try:
            return next_action(episodes)
        finally:
            inside.pop()

    def adapt_kept(episodes):
        fast, g, prefix = adapt(episodes)
        for j, ordinal in run.capture_rows:
            run.captured[ordinal] = {
                "action_logits": torch.stack([a[j, s] for s, a in enumerate(run.action_logits)]),
                "g": {k: v[j].detach().clone() for k, v in g.items()},
                "fast": {k: (v[j] if k in g else v).detach().clone() for k, v in fast.items()}}
        return fast, g, prefix

    task.fusion_apply, task.next_action, task.adapt = fusion_kept, next_action_kept, adapt_kept


def _chunk(run, first=None):
    """One chunk of episodes: (pool indices, (E, 4) actions, predictions on
    the host, seconds). `first` is the window's ordinal of its first
    episode (None outside the window)."""
    task = run.objects["task"]
    e = run.traffic["chunk"]
    eps = np.asarray([next(run.order) for _ in range(e)])
    run.capture_rows = [] if first is None else [
        (j, first + j) for j in range(e) if first + j in run.checked]
    run.action_logits = []
    buf = run.buf
    t0 = time.perf_counter()
    state = np.zeros(e, np.int64)
    buf[:, 0] = run.grid[eps, 0]
    actions = []
    for s in range(1, C.NUM_FRAMES):
        a = np.asarray(task.next_action({"frames": buf[:, :s]}).tolist())
        actions.append(a)
        state = run.next_state[state, a]
        buf[:, s] = run.grid[eps, state]
    pred = {k: v.cpu() for k, v in task.predict({"frames": buf}).items()}
    return eps, np.stack(actions, 1), pred, time.perf_counter() - t0


def window(run):
    run.sync()
    t0 = time.perf_counter()
    records, latencies, failed = [], [], 0
    while True:
        eps, actions, pred, secs = _chunk(run, len(records))
        ok = torch.isfinite(pred["pred_logits"]).flatten(1).all(1) & torch.isfinite(
            pred["pred_boxes"]).flatten(1).all(1)
        failed += int((~ok).sum())
        records += [(int(eps[j]), actions[j], {k: v[j] for k, v in pred.items()})
                    for j in range(len(eps))]
        latencies += [secs] * len(eps)
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window.update(seconds=time.perf_counter() - t0, episodes=len(records),
                      attempted=len(records), failed=failed, latencies=latencies)
    run.records = records


def stretch(run):
    from portbench.lib.profile import profile

    n = run.traffic["stretch_chunks"]
    return profile(run, lambda: [_chunk(run) for _ in range(n)], n * run.traffic["chunk"])


def _frames(run, ep, actions):
    """(1, 5, H, W, 3) frames of pool episode `ep` under `actions`."""
    state, idx = 0, [0]
    for a in actions:
        state = run.next_state[state, a]
        idx.append(state)
    return run.grid[ep, idx][None]


def _fast(ref, g, rnd):
    """The fast weights of the inner step by g (adapted leaves (1, ...)) as
    the configuration states it, every value rounded by `rnd`: p and g
    rounded, lr*g rounded and clipped, the difference rounded (each op in
    fp32, then rounded, as an elementwise kernel of that type computes); the
    q/k/v in-projections, not adapted, rounded."""
    adapted, static = split_inner(dict(ref.detector.named_parameters()))
    lr, clip = (float(rnd(torch.tensor(x, dtype=torch.float64))) for x in (ref.adaptive_lr, 0.01))
    fast = {k: rnd(rnd(p) - rnd(torch.clamp(lr * rnd(g[k].float()), -clip, clip)))
            for k, p in adapted.items()}
    return {**fast, **{k: rnd(v) for k, v in static.items()}}


def bf16(x):
    return x.to(torch.bfloat16).float()


def _stated(ref):
    """The rounding of the configuration's inner step: to bf16, or fp32's."""
    return bf16 if ref.fast_dtype is not None else (lambda x: x.float())


def _judge(ref, ref_r, run, ep, actions, state, pred):
    """The numbers of one checked episode, on the frames the served actions
    led to; the limits file names those compared, the rest are printed.
    The actions: the program's action logits at s = 1..4 against the
    reference's, the largest gap over the largest logit (`action_err`) and
    that in units of what rounding the weights to bf16 moves the
    reference's (`action_units`); the reference's logit of each served
    action below its best (`action_gap`). Adapt's inner gradient against
    the reference's: the median leaf's relative error (`g_raw`), and that
    in units of what rounding the weights to bf16 moves the reference's
    (`g_err`, the unit `g_unit`).
    The fast weights against the step the configuration states, taken by
    the reference from the program's gradient (`step_err`: 0 when they
    agree bit for bit, 1 for no step). The served predictions against the
    reference's detect with the program's fast weights (`logits_err`,
    `boxes_err`) and against its own adapted detect (`own_logits_err`)."""
    fr = _frames(run, ep, actions)
    fr_s = [{"frames": fr[:, :s]} for s in range(1, C.NUM_FRAMES)]
    logits = torch.stack([ref.action_logits(f)[0] for f in fr_s]).cpu()
    logits_r = torch.stack([ref_r.action_logits(f)[0] for f in fr_s]).cpu()
    got = logits[torch.arange(len(actions)), torch.as_tensor(actions)]
    prog_logits = state["action_logits"].float().cpu()
    g_ref, prefix = ref.inner_grad({"frames": fr})
    g_rounded, _ = ref_r.inner_grad({"frames": fr})
    g_prog = {k: v[None] for k, v in state["g"].items()}
    unit = compare.median_leaf_err(g_rounded, g_ref)
    expected = _fast(ref, g_prog, _stated(ref))
    base = _fast(ref, {k: torch.zeros_like(v) for k, v in g_prog.items()}, _stated(ref))
    fast_prog = {k: v.float()[None] if k in g_prog else v.float() for k, v in state["fast"].items()}
    step = sum(float((fast_prog[k] - v).norm()) ** 2 for k, v in expected.items()) ** 0.5
    moved = sum(float((v - base[k]).norm()) ** 2 for k, v in expected.items()) ** 0.5
    det = ref.detect(fast_prog, prefix, 1)
    own = ref.detect(_fast(ref, g_ref, _stated(ref)), prefix, 1)["pred_logits"][0].cpu()
    rl = det["pred_logits"][0].cpu()
    served = pred["pred_logits"].float()
    action_err = float((prog_logits - logits).abs().max() / logits.abs().max())
    g_raw = compare.median_leaf_err(g_prog, g_ref)
    return {"action_err": action_err,
            "action_units": action_err / max(float((logits_r - logits).abs().max()
                                                   / logits.abs().max()), 1e-30),
            "action_gap": float((logits.max(-1).values - got).max()),
            "g_err": g_raw / unit, "g_raw": g_raw, "g_unit": unit,
            "step_err": step / max(moved, 1e-30),
            "logits_err": float((served - rl).abs().max() / rl.abs().max()),
            "boxes_err": float((pred["pred_boxes"].float()
                                - det["pred_boxes"][0].cpu()).abs().max()),
            "own_logits_err": float((served - own).abs().max() / own.abs().max())}


def control(run):
    """The control in the program's place: the reference one precision step
    below bf16 serves `check_episodes` episodes one at a time: every matmul
    and convolution on fp8 operands, and the inner step's values fp8 where
    the configuration states bf16. Its action logits, inner gradients and
    fast weights are kept as the program's are."""
    from portbench.lib.precision import Fp8Matmuls, to_fp8

    prepare(run)
    run.records, run.captured = [], {}
    with fp32(), Fp8Matmuls():
        ref = compare.reference(run.model_config, run.weights, run.device)
        for i in range(run.traffic["check_episodes"]):
            ep, actions, logits = next(run.order), [], []
            for s in range(1, C.NUM_FRAMES):
                logits.append(ref.action_logits({"frames": _frames(run, ep, actions)})[0])
                actions.append(int(logits[-1].argmax()))
            g, prefix = ref.inner_grad({"frames": _frames(run, ep, actions)})
            fast = _fast(ref, g, to_fp8)
            pred = ref.detect(fast, prefix, 1)
            run.captured[i] = {"action_logits": torch.stack(logits),
                               "g": {k: v[0] for k, v in g.items()},
                               "fast": {k: (v[0] if k in g else v) for k, v in fast.items()}}
            run.records.append((ep, np.asarray(actions),
                                {k: v[0].detach().cpu() for k, v in pred.items()}))
    run.checked = set(run.captured)
    del ref


def check(run):
    """Free the program, then judge the checked episodes with the fp32
    reference (and the same with its weights rounded to bf16, for
    `g_err`'s unit); each number is the worst over them."""
    run.objects.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    picked = [(i, run.records[i]) for i in sorted(run.checked) if i < len(run.records)]
    rounded = {k: bf16(v) if v.is_floating_point() else v for k, v in run.weights.items()}
    with fp32():
        ref = compare.reference(run.model_config, run.weights, run.device)
        ref_r = compare.reference(run.model_config, rounded, run.device)
        judged = [_judge(ref, ref_r, run, ep, actions, run.captured[i], pred)
                  for i, (ep, actions, pred) in picked]
    compared = list(run.limits)
    run.extra = {n: max(j[n] for j in judged) for n in (judged[0] if judged else ())
                 if n not in compared}
    run.extra["episodes"] = judged
    # a checked episode that never finished counts as wrong
    return [(n, max((j[n] for j in judged), default=float("inf")), float(run.limits[n]))
            for n in compared]
