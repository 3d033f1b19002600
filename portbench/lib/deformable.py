"""The pieces of the benchmark that Deformable DETR's configurations need
beside those of lib/weights.py, lib/compare.py and lib/flops.py, which
build reference/task.py's ReferenceTask: the same functions for
reference/deformable_task.py's task.

Weights (`make`): lib/weights.py's draw for every module it knows (he-normal
convs, the Dense layers' spreads, LayerNorm, FrozenBatchNorm, the fusion),
unit-normal `query_embed` and `level_embed` (the published nn.Embedding and
normal_ inits), the published constants of each MSDeformAttn
(`sampling_offsets`: zero weight, the direction grid as bias;
`attention_weights`: zero), GroupNorm's ones and zeros, all from one flat
draw on the device; then each FrozenBatchNorm takes its input's mean and
variance on one seeded batch of noise frames, as in lib/weights.py. No
input projection is rescaled: each level's GroupNorm already gives the
encoder unit-variance features.
"""

import contextlib

import torch

from portbench.lib import flops, weights
from portbench.lib.precision import fp32
from portbench.reference import deformable_detr, layers
from portbench.reference.config import Config
from portbench.reference.deformable_task import reference_task


def reference(model_config, state, device):
    """lib/compare.py's `reference` for any detector: the fp32 reference task
    holding `state`."""
    task = reference_task(Config(model_config), device)
    task.load_state_dict({k: v.to(device) for k, v in state.items()})
    return task


@torch.no_grad()
def make(model, seed, size, calib_frames=5):
    """lib/weights.py's `make` for a reference task whose detector is
    Deformable DETR; returns its state dict."""
    device = next(model.parameters()).device
    gen = torch.Generator(device).manual_seed(int(seed))
    fixed = [m for m in model.modules() if isinstance(m, deformable_detr._Fixed)]
    constant = {id(p) for m in fixed for p in (m.weight, m.bias)}
    det = model.detector
    spreads = [(p, std) for p, std in weights._spreads(model) if id(p) not in constant]
    spreads += [(det.query_embed, 1.0), (det.level_embed, 1.0)]
    flat = torch.randn(sum(p.numel() for p, _ in spreads), generator=gen, device=device)
    at = 0
    for p, std in spreads:
        p.copy_(flat[at:at + p.numel()].view_as(p) * std)
        at += p.numel()
    del flat
    for m in fixed:
        m.weight.zero_()
        m.bias.copy_(m.initial)
    frames = weights.noise_frames(gen, calib_frames, size, device)
    bns = [m for m in model.modules() if isinstance(m, layers.FrozenBatchNorm)]

    def set_stats(mod, args):
        x = args[0].float()
        mod.running_mean.copy_(x.mean((0, 2, 3)))
        mod.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in bns]
    try:
        with fp32():
            det(frames)
    finally:
        for h in hooks:
            h.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def _task_class():
    saved = flops.ReferenceTask
    flops.ReferenceTask = reference_task
    try:
        yield
    finally:
        flops.ReferenceTask = saved


def count(config_dict, inner_batch=None):
    """lib/flops.py's `count` for any detector. The deformable attention's
    bilinear sums are elementwise work and count nothing, as the
    attention's softmax does not."""
    with _task_class():
        return flops.count(config_dict, inner_batch)
