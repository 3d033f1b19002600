"""Multi-scale deformable attention of the reference: the published plain
PyTorch core (Deformable-DETR, models/ops/functions/ms_deform_attn_func.py,
`ms_deform_attn_core_pytorch`), bilinear sampling by `grid_sample` with
align_corners=False and zero padding, in fp32. Independent of the port's
formulation (ops/ms_deform_attn.py gathers the taps with indexing ops).

    value     (N, S, H*D), S = sum of the levels' H_l * W_l, level-major
    shapes    ((H_0, W_0), ...)
    locations (N, Lq, H, L, P, 2) (x, y) in [0, 1]
    weights   (N, Lq, H, L, P)
    -> (N, Lq, H*D)
"""

import torch
import torch.nn.functional as F


def ms_deform_attn(value, shapes, locations, weights):
    n, s, hd = value.shape
    _, lq, h, lv, p, _ = locations.shape
    d = hd // h
    maps = value.float().split([a * b for a, b in shapes], dim=1)
    grids = 2 * locations.float() - 1
    sampled = []
    for lvl, (hh, ww) in enumerate(shapes):
        v = maps[lvl].reshape(n, hh * ww, h, d).permute(0, 2, 3, 1).reshape(n * h, d, hh, ww)
        g = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)  # (N*H, Lq, P, 2)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))  # (N*H, D, Lq, P)
    a = weights.float().transpose(1, 2).reshape(n * h, 1, lq, lv * p)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1)  # (N*H, D, Lq)
    return out.view(n, h * d, lq).transpose(1, 2)
