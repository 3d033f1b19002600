"""The weights both sides run: drawn from the seed on the card in one call,
then FrozenBatchNorm statistics calibrated by the reference model.

Each tensor takes the spread of its module's initialiser in the port
(he-normal convs, lecun / xavier / 0.02 Dense kernels, unit-normal DETR
queries, 0.02 ViT positions, the action tokens' kaiming-uniform spread),
as a normal draw of that standard deviation from one flat
`torch.randn(generator=...)` on the device; biases, LayerNorm and zero-
initialised tables as the port sets them. With identity statistics the
random ResNet's activations grow through the trunk until the step's
gradients overflow in bf16, so each FrozenBatchNorm takes the mean and
variance of its own input on one seeded batch of noise frames, as
pretrained statistics would be (the reference in fp32, TF32 off). The
residual sums still grow through the trunk, so DETR's `input_proj` is then
scaled to give unit-variance features on that batch: without it the
encoder's first attention logits reach hundreds, its q/k gradients 1e4 to
1e6 in fp32, and the bf16 step goes non-finite (measured on the H100).
"""

import math

import torch

from portbench.lib.precision import fp32
from portbench.reference import detr, fusion, layers, vit

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _spreads(model):
    """[(parameter, std)] of the randomly drawn tensors, after setting the
    deterministic ones in place."""
    out = []
    for mod in model.modules():
        if isinstance(mod, layers.Conv2d):
            out.append((mod.weight, math.sqrt(2.0 / mod.weight[0].numel())))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, layers.Dense):
            fo, fi = mod.weight.shape
            std = {"lecun": math.sqrt(1.0 / fi), "xavier": math.sqrt(2.0 / (fi + fo))}.get(
                mod.kernel_init, 0.02)
            out.append((mod.weight, std))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (layers.LayerNorm, layers.FrozenBatchNorm)):
            mod.init_weights(None)
        elif isinstance(mod, detr.DETR):
            out.append((mod.query_embed, 1.0))
        elif isinstance(mod, vit.ViT):
            out.append((mod.pos_embed, 0.02))
        elif isinstance(mod, (fusion.FusionGPT, fusion.FusionXAttn)):
            t = mod.action_tokens
            out.append((t, 1.0 / math.sqrt(3.0 * t.shape[1] * t.shape[2])))
            getattr(mod, "seq_pos_embed", getattr(mod, "query_embed", None)).zero_()
    return out


def noise_frames(gen, n, size, device):
    """(n, size, size, 3) uniform noise frames, ImageNet-normalised."""
    img = torch.rand(n, size, size, 3, generator=gen, device=device)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return (img - mean) / std


@torch.no_grad()
def make(model, seed, size, calib_frames=5):
    """Fill the reference `model` (on its device) from `seed`; returns its
    state dict, the weights both sides load."""
    device = next(model.parameters()).device
    gen = torch.Generator(device).manual_seed(int(seed))
    spreads = _spreads(model)
    flat = torch.randn(sum(p.numel() for p, _ in spreads), generator=gen, device=device)
    at = 0
    for p, std in spreads:
        p.copy_(flat[at:at + p.numel()].view_as(p) * std)
        at += p.numel()
    del flat
    frames = noise_frames(gen, calib_frames, size, device)
    bns = [m for m in model.modules() if isinstance(m, layers.FrozenBatchNorm)]

    def set_stats(mod, args):
        x = args[0].float()
        mod.running_mean.copy_(x.mean((0, 2, 3)))
        mod.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    def unit_scale(mod, args, out):
        mod.weight.div_(out.float().std())

    proj = model.detector.input_proj
    hooks = [m.register_forward_pre_hook(set_stats) for m in bns]
    hooks.append(proj.register_forward_hook(unit_scale))
    try:
        with fp32():
            model.detector(frames)
    finally:
        for h in hooks:
            h.remove()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
