"""Served-episode traffic for a configuration whose detector is Deformable
DETR: drivers/serve.py's traffic, window, stretch and comparison, the
same code on the same parameters, with the plain reference, its weights
and its FLOP counts taken from lib/deformable.py (reference/task.py's
ReferenceTask builds DETR's detectors only).

A private copy of serve.py is loaded and its reference, weights,
`compare.reference` and `_judge` are rebound; nothing of serve.py changes
for its own cells. `portbench/readings.py` runs a window only for the
driver named "serve", so `check` runs one first where none ran.

One more compared number, `msda_err`, judges the deformable attention's
sampling where the predictions cannot see it (a location rounded to bf16
moves the 38-wide level's taps by up to 0.07 pixel, and 12 layers of bf16
rounding hide that in the logits). For each checked episode the first
encoder layer's deformable attention is kept as adapt's inner pass ran it
on the episode's frame 0: its query, and the value maps, locations and sum
of its MSDA op. The judge computes the locations and weights from that
query in fp32 with the layer's bf16-rounded weights (the program's own) and
the reference's grid_sample core on the program's value maps:
`msda_err` is ||sum_program - sum_ref|| / ||sum_ref||, the rounding of the
bf16 sum in a sound program. `loc_px`, the largest gap between the
program's locations and those in pixels of their level, is printed. The
control keeps the same from the reference it serves with.

Planted faults for the readings (`run.fault`, besides serve.py's): a
program whose deformable attention reads its sampling locations rounded
to bf16 (`bf16_locations`), or drops the 4th level's samples
(`level_dropped`), in every pass, forward and backward.
"""

import os
import types

import torch

from portbench.lib import bench, compare, deformable
from portbench.reference import deformable_detr as ref_detr
from portbench.reference.ms_deform_attn import ms_deform_attn as grid_sample_core

_serve = bench.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "serve.py"),
                           "portbench_serve_for_deformable")
_serve.ReferenceTask = deformable.reference_task
_serve.weights = types.SimpleNamespace(make=deformable.make)
_serve.compare = types.SimpleNamespace(reference=deformable.reference,
                                       median_leaf_err=compare.median_leaf_err)

prepare, window, stretch, _chunk = _serve.prepare, _serve.window, _serve.stretch, _serve._chunk


class _Kept:
    """Keeps the first encoder layer's deformable attention of `rows` (rows
    of its frames) on the next pass: the layer's query (a forward pre-hook
    on the layer) and its op's value maps, locations and sum (`op` wraps
    the op)."""

    def __init__(self):
        self.rows, self.query, self.kept = None, None, None

    def hook(self, module, args):
        if self.rows is not None and self.kept is None:
            self.query = args[0]

    def op(self, fn):
        def kept(value, shapes, locations, weights, *a, **kw):
            out = fn(value, shapes, locations, weights, *a, **kw)
            if self.query is not None:
                self.kept = {r: {"query": self.query[r].detach().clone(),
                                 "value": value[r].detach().clone(),
                                 "locations": locations[r].detach().clone(),
                                 "out": out[r].detach().clone(), "shapes": shapes}
                             for r in self.rows}
                self.query = None
            return out

        return kept

    def around(self, fn, rows):
        """Call `fn` keeping `rows`; returns (its result, {row: kept})."""
        self.rows, self.query, self.kept = rows, None, None
        try:
            return fn(), self.kept or {}
        finally:
            self.rows, self.query, self.kept = None, None, None


def _keep_msda(run, task):
    """Keep, for each checked episode, its frame 0's first encoder layer in
    adapt's inner pass (`run.captured[ordinal]["msda"]`)."""
    from interactron_tpu_torch.ops import ms_deform_attn as op

    k = _Kept()
    task.detector.encoder_layer0.self_attn.register_forward_pre_hook(k.hook)
    op.ms_deform_attn_fwd = k.op(op.ms_deform_attn_fwd)
    adapt = task.adapt

    def adapt_kept(episodes):
        if not run.capture_rows:
            return adapt(episodes)
        s = len(episodes["frames"][0])
        out, kept = k.around(lambda: adapt(episodes), [j * s for j, _ in run.capture_rows])
        for j, ordinal in run.capture_rows:
            run.captured[ordinal]["msda"] = kept.get(j * s)
        return out

    task.adapt = adapt_kept


def control(run):
    """serve.py's control, keeping each episode's first encoder layer from
    the reference it serves with, in its inner gradient's pass."""
    k, kept = _Kept(), []

    def reference(*a):
        ref = deformable.reference(*a)
        ref.detector.encoder_layer0.self_attn.register_forward_pre_hook(k.hook)
        inner_grad = ref.inner_grad

        def inner_grad_kept(episodes):
            out, rows = k.around(lambda: inner_grad(episodes), [0])
            kept.append(rows.get(0))
            return out

        ref.inner_grad = inner_grad_kept
        return ref

    saved = _serve.compare.reference, ref_detr.ms_deform_attn
    _serve.compare.reference, ref_detr.ms_deform_attn = reference, k.op(saved[1])
    try:
        _serve.control(run)
    finally:
        _serve.compare.reference, ref_detr.ms_deform_attn = saved
    for i, m in enumerate(kept):
        run.captured[i]["msda"] = m


def _msda_numbers(ref_r, state):
    """`msda_err` and `loc_px` of one checked episode (the module's
    docstring); a frame whose layer was not kept reads inf."""
    m = state.get("msda")
    if m is None:
        return {"msda_err": float("inf"), "loc_px": float("inf")}
    layer = ref_r.detector.encoder_layer0.self_attn
    dev = next(layer.parameters()).device
    shapes = m["shapes"]
    locations, weights = layer.sampling(m["query"].float()[None].to(dev),
                                        ref_detr.centres(shapes, dev), shapes)
    want = grid_sample_core(m["value"].float()[None].to(dev), shapes, locations, weights)[0]
    got = m["out"].float().to(dev)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
    gap = (m["locations"].float().to(dev) - locations[0]).abs() * wh[:, None]
    return {"msda_err": float((got - want).norm() / want.norm()), "loc_px": float(gap.max())}


_judge = _serve._judge
_serve._judge = lambda ref, ref_r, run, ep, actions, state, pred: {
    **_judge(ref, ref_r, run, ep, actions, state, pred), **_msda_numbers(ref_r, state)}


def _plant(fault):
    """Wrap the program's deformable attention wrappers with `fault`."""
    from interactron_tpu_torch.ops import ms_deform_attn as op

    def planted(value, shapes, locations, weights):
        if fault == "bf16_locations":
            return value, shapes, locations.to(torch.bfloat16).float(), weights
        keep = torch.ones(len(shapes), device=weights.device)
        keep[3:] = 0.0
        return value, shapes, locations, weights * keep[:, None]

    fwd, bwd = op.ms_deform_attn_fwd, op.ms_deform_attn_bwd
    op.ms_deform_attn_fwd = lambda v, s, loc, w, out=None: fwd(*planted(v, s, loc, w), out=out)
    op.ms_deform_attn_bwd = lambda v, s, loc, w, go: bwd(*planted(v, s, loc, w), go)


def setup(run):
    """serve.py's set-up, after the program has built the configuration's
    task on the meta device: a program without this detector raises here,
    before any weight is made."""
    from interactron_tpu_torch.utils.config import Config, build_model

    with torch.device("meta"):
        build_model(Config(run.model_config), device="meta")
    if run.fault in ("bf16_locations", "level_dropped"):
        _plant(run.fault)
    _serve.setup(run)
    _keep_msda(run, run.objects["task"])


def check(run):
    if not hasattr(run, "records"):
        window(run)
    return _serve.check(run)
