"""Inner-step pieces of the adaptive detector (a frozen copy of the port's
module; counterpart of interactron_tpu/meta.py), on flat {dotted name:
tensor} dicts."""

import torch


def _inner_static(name):
    """Reference quirk: the inner step adapts only the parameters of leaf
    modules, which leaves out the q/k/v in-projections of every DETR
    self_attn/cross_attn (torch.nn.MultiheadAttention is not a leaf). They
    keep their original values in the fast weights."""
    parts = name.split(".")
    return any(p in ("self_attn", "cross_attn") for p in parts) and any(
        p in ("q_proj", "k_proj", "v_proj") for p in parts
    )


def split_inner(det_params):
    """(adapted, static) partition of the detector's named parameters."""
    adapted = {k: v for k, v in det_params.items() if not _inner_static(k)}
    static = {k: v for k, v in det_params.items() if _inner_static(k)}
    return adapted, static


def merge_inner(adapted, static):
    return {**adapted, **static}


def clipped_sgd_step(params, grads, lr, clip=0.01, dtype=None):
    """p - clip(lr * g, -clip, +clip) per entry. With `dtype` the step is
    taken in that precision: p and g are cast first, then subtracted. lr and
    the clip bounds are rounded to g's dtype, as JAX's weakly typed scalars
    are."""
    out = {}
    for name, p in params.items():
        g = grads[name]
        if dtype is not None:
            p, g = p.to(dtype), g.to(dtype)
        like = lambda x: torch.tensor(x, dtype=g.dtype).item()  # host-side rounding
        out[name] = p - torch.clamp(like(lr) * g, like(-clip), like(clip)).to(p.dtype)
    return out


def learned_loss_value(fusion_out):
    """Frobenius norm of each episode's per-prediction loss tokens, summed
    over the fusion's batch of episodes: the gradient with respect to an
    episode's own fast weights is that of its own norm, as under JAX's vmap."""
    x = fusion_out["loss"].float()
    return torch.sqrt(torch.sum((x * x).flatten(1), dim=1)).sum()
