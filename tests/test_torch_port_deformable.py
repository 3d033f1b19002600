"""Deformable DETR as Interactron's detector (`MODEL.BACKBONE:
resnet50_deformable`; here `tiny_deformable`, 2 encoder and 2 decoder
layers, small maps) against the plain fp32 reference in
portbench/reference/ on the CPU, on the port's seeded weights: the
deformable attention's plain versions (the port's indexing formulation, its
explicit backward) against the published grid_sample core; the detector's
outputs at 2 and 4 levels; next_action's action logits; adapt's inner
gradients and fast weights; predict. Also: a CUDA graph's capture ends a
piece at each deformable attention sum; meta-training refuses this
detector; the recorder's msda spans.

Tolerances. Both sides are fp32 with the same weights and inputs; they
differ in how they sum (gather and explicit sums against grid_sample; the
port's batched layouts), so every compared number is held to fp32 rounding
carried through a few layers: 1e-5 x max|ref| for the op and its
gradients, 1e-4 x max|ref| for the detector's, fusion's and predict's
outputs (2 + 2 layers, a 4-layer fusion), and the median leaf's relative
error 1e-4 for adapt's gradients (a sum over every layer's backward)."""

import statistics

import numpy as np
import pytest
import torch

from interactron_tpu_torch.models import deformable_detr
from interactron_tpu_torch.models.deformable_detr import DeformableDETR
from interactron_tpu_torch.ops import ms_deform_attn as op
from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils import cuda_graphs, profiling
from interactron_tpu_torch.utils.config import Config
from portbench.reference import deformable_detr as ref_detr
from portbench.reference.config import Config as RefConfig
from portbench.reference.deformable_task import DeformableReferenceTask
from portbench.reference.ms_deform_attn import ms_deform_attn as ref_msda
from tiny_config import tiny_config

IMG = 96  # levels 12x12, 6x6, 3x3, 2x2


def deformable_config(levels=4):
    d = tiny_config().to_dict()
    d["MODEL"].update(BACKBONE="tiny_deformable", TEST_RESOLUTION=IMG, D_MODEL=32,
                      NUM_FEATURE_LEVELS=levels, DETR_FF_DIM=32, NUM_ENCODER_LAYERS=2,
                      NUM_DECODER_LAYERS=2, IMG_FEATURE_SIZE=32, BOX_EMB_SIZE=32,
                      BLOCK_SIZE=5 * ((IMG // 16) ** 2 + 6) + 5)
    return d


@pytest.fixture(scope="module")
def pair():
    """The port's task (seed 3) and the reference task holding its weights,
    dropout off on both (no generator is passed)."""
    d = deformable_config()
    task = InteractronTask(Config(d), device="cpu").init(3)
    ref = DeformableReferenceTask(RefConfig(d), "cpu")
    ref.load_state_dict(task.state_dict())
    frames = np.random.RandomState(4).randn(2, 5, IMG, IMG, 3).astype(np.float32)
    return task, ref, frames


def _close(got, want, tol):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (err, float(want.abs().max()))


@pytest.mark.parametrize("shapes,n,lq,h,d,p", [(((6, 7), (3, 4), (2, 2)), 2, 5, 3, 8, 4),
                                               (((12, 12), (6, 6)), 1, 9, 2, 16, 2),
                                               (((4, 8), (2, 4)), 1, 3, 1, 8, 2)])
def test_msda_plain_matches_grid_sample(shapes, n, lq, h, d, p):
    """The port's op (gather forward, explicit backward) against the
    published grid_sample core: output and dValue, dLocations, dWeights, with
    locations past every edge of the maps, and one whose pixel coordinates
    are exactly -1 (its inside corners' weights are 0, their slopes not)."""
    g = torch.Generator().manual_seed(0)
    s, lv = sum(a * b for a, b in shapes), len(shapes)
    value = torch.randn(n, s, h * d, generator=g).requires_grad_()
    loc = torch.rand(n, lq, h, lv, p, 2, generator=g) * 1.4 - 0.2
    loc[0, 0, 0, 0, 0] = torch.tensor([-0.5 / shapes[0][1], -0.5 / shapes[0][0]])
    loc.requires_grad_()
    w = torch.softmax(torch.randn(n, lq, h, lv * p, generator=g), -1).view(n, lq, h, lv, p)
    w.requires_grad_()
    go = torch.randn(n, lq, h * d, generator=g)
    got, want = op.ms_deform_attn(value, shapes, loc, w), ref_msda(value, shapes, loc, w)
    _close(got, want, 1e-5)
    for a, b in zip(torch.autograd.grad(got, (value, loc, w), go),
                    torch.autograd.grad(want, (value, loc, w), go)):
        _close(a, b, 1e-5)
    assert op.launches == {"msda_fwd": 0, "msda_bwd": 0}  # the plain versions ran


@pytest.mark.parametrize("levels", [2, 4])
def test_detector_matches_reference(levels):
    d = deformable_config(levels)
    det = InteractronTask(Config(d), device="cpu").init(levels).detector
    ref = ref_detr.build(RefConfig(d).MODEL)
    ref.load_state_dict(det.state_dict())
    images = torch.as_tensor(np.random.RandomState(5).randn(3, IMG, IMG, 3).astype(np.float32))
    with torch.no_grad():
        got, want = det(images), ref(images)
    assert got["embedded_memory_features"].shape == (3, (IMG // 16) ** 2, 32)
    assert got["box_features"].shape == (3, 6, 32)
    for k in want:
        _close(got[k], want[k], 1e-4)


def test_next_action_logits_match_reference(pair):
    task, ref, frames = pair
    kept, fusion_apply = [], task.fusion_apply
    task.fusion_apply = lambda *a, **kw: kept.append(fusion_apply(*a, **kw)) or kept[-1]
    try:
        for s in range(1, 5):
            ep = {"frames": frames[:, :s]}
            actions = task.next_action(ep)
            want = ref.action_logits(ep)
            _close(kept[-1]["actions"][:, s - 1], want, 1e-4)
            assert torch.equal(actions, want.argmax(-1))
    finally:
        task.fusion_apply = fusion_apply


def test_adapt_matches_reference(pair):
    """adapt's inner gradients (every adapted leaf, each episode's own) and
    fast weights against the reference's inner_grad and step."""
    task, ref, frames = pair
    fast, g, _ = task.adapt({"frames": frames})
    g_ref, _ = ref.inner_grad({"frames": frames})
    assert set(g) == set(g_ref)
    assert "encoder_layer0.self_attn.sampling_offsets.weight" in g
    assert not any(k.startswith("decoder_layer0.self_attn.q_proj") for k in g)
    errs = [float((g[k] - v).norm() / v.norm().clamp(min=1e-30)) for k, v in g_ref.items()]
    assert statistics.median(errs) <= 1e-4, statistics.median(errs)
    want = ref.fast_weights(g)
    assert set(fast) == set(want)
    for k, v in want.items():
        _close(fast[k], v, 1e-6)


def test_predict_matches_reference(pair):
    task, ref, frames = pair
    got, want = task.predict({"frames": frames}), ref.predict({"frames": frames})
    for k in ("pred_logits", "pred_boxes"):
        assert got[k].shape == (2, 1, 6, 8 if k == "pred_logits" else 4)
        _close(got[k], want[k], 1e-4)


class Pieces:
    """Records the calls a capture would end a piece at."""

    def __init__(self):
        self.msda_calls, self.attention_calls = [], []

    def msda(self, value, shapes, locations, weights):
        self.msda_calls.append((tuple(value.shape), shapes, tuple(locations.shape)))
        return torch.zeros(*locations.shape[:2], value.shape[2])

    def attention(self, q, k, v, num_heads, rate=0.0):
        self.attention_calls.append(tuple(q.shape))
        return torch.zeros_like(q)

    def module(self, module, x):
        cuda_graphs._local.graph = None  # the conv runs for real, between pieces
        try:
            return module(x)
        finally:
            cuda_graphs._local.graph = self


def test_capture_ends_a_piece_at_each_deformable_attention(monkeypatch, pair):
    """Under an open capture every MSDA sum of the detector (2 encoder, 2
    decoder layers) goes to the graph's `msda`, with the levels' shapes, and
    nothing runs the op; the decoder's 6-query self-attention is under the
    flash gates and stays in the piece."""
    task = pair[0]
    rec = Pieces()
    monkeypatch.setattr(cuda_graphs._local, "graph", rec, raising=False)
    spans = []
    monkeypatch.setattr(deformable_detr, "ms_deform_attn", lambda *a: spans.append(a))
    with torch.no_grad():
        task.detector(torch.zeros(2, IMG, IMG, 3))
    levels = ((12, 12), (6, 6), (3, 3), (2, 2))
    s = sum(a * b for a, b in levels)
    assert rec.msda_calls == [((2, s, 32), levels, (2, s, 2, 4, 4, 2))] * 2 + [
        ((2, s, 32), levels, (2, 6, 2, 4, 4, 2))] * 2
    assert rec.attention_calls == [] and spans == []


def test_meta_training_refuses_deformable(pair):
    task = pair[0]
    from tiny_config import tiny_batch

    batch = tiny_batch(np.random.RandomState(0))
    batch["frames"] = np.random.RandomState(1).randn(2, 5, IMG, IMG, 3).astype(np.float32)
    with pytest.raises(NotImplementedError, match="second-order"):
        task.grads_and_metrics(batch, torch.Generator().manual_seed(0))


def test_recorder_spans_each_msda_call(pair):
    """On the CPU the plain versions run inside `msda.fwd` / `msda.bwd` spans
    and launch nothing: no `msda.launches`, no launch record."""
    task, _, frames = pair
    profiling.take()
    profiling.enable(True)
    try:
        task.predict({"frames": frames})
    finally:
        profiling.enable(False)
    rec = profiling.take()
    names = [s.name for s in rec["spans"]]
    # adapt's pass (2 + 2) and its backward, then the frame-0 detect
    assert names.count("msda.fwd") == 8 and names.count("msda.bwd") == 4
    assert rec["msda"] == [] and "msda.launches" not in rec["counters"]
    assert isinstance(task.detector, DeformableDETR)
