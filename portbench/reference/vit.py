"""ViT-B/16 backbone of the scaled configuration (a frozen copy of the port's
module; counterpart of interactron_tpu/models/vit.py): the same stride-16
feature map as ResNet-50-DC5, so DETR and both fusion transformers compose
unchanged.

Pre-LN blocks with exact GELU; patchify is a crop to a multiple of the
patch, a reshape and a Dense over (patch row, patch column, channel), the
JAX module's layout, so its `patch_embed` kernel carries across as is. The
attention is the shared packed MHA, so the t = s = 361 problems take the
kernels. Nothing is frozen: the meta inner step adapts the whole backbone,
q/k/v projections included (the module is `attn`, not a DETR
`self_attn`/`cross_attn`).
"""

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    Dense,
    Dropout,
    LayerNorm,
    MultiHeadAttention,
    by_episode,
    with_episodes,
)


class ViTBlock(nn.Module):
    def __init__(self, width, num_heads, dropout_rate, dtype):
        super().__init__()
        self.ln1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, num_heads, dropout_rate, dtype)
        self.ln2 = LayerNorm(width)
        self.mlp_fc = Dense(width, 4 * width, dtype=dtype, kernel_init="normal02")
        self.mlp_proj = Dense(4 * width, width, dtype=dtype, kernel_init="normal02")
        self.dropout = Dropout(dropout_rate)

    def forward(self, x, gen=None):
        h = self.ln1(x)
        x = x + self.dropout(self.attn(h, h, h, gen), gen)
        h = self.mlp_proj(F.gelu(self.mlp_fc(self.ln2(x)), approximate="none"))
        return x + self.dropout(h, gen)


class ViT(nn.Module):
    """forward(images) with NHWC images (B, H, W, 3) returns the NHWC
    feature map (B, H // patch, W // patch, width)."""

    def __init__(self, width=768, num_layers=12, num_heads=12, patch=16, dropout_rate=0.0,
                 grid=19, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.width = width
        self.patch = patch
        self.num_layers = num_layers
        self.patch_embed = Dense(patch * patch * 3, width, dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(grid * grid, width))
        for i in range(num_layers):
            self.add_module(f"block{i}", ViTBlock(width, num_heads, dropout_rate, dtype))
        self.ln_f = LayerNorm(width)

    def init_weights(self, gen):
        with torch.no_grad():
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=gen)

    def forward(self, images, gen=None):
        b, hh, ww, c = images.shape
        p = self.patch
        gh, gw = hh // p, ww // p
        if gh * gw != self.pos_embed.shape[-2]:
            raise ValueError(f"{gh}x{gw} patches, the position table has "
                             f"{self.pos_embed.shape[-2]}")
        x = images[:, : gh * p, : gw * p].reshape(b, gh, p, gw, p, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * c)
        x = self.patch_embed(x.to(self.dtype))
        xv, pv = by_episode(x, with_episodes(self.pos_embed.to(self.dtype), 2))
        x = (xv + pv).reshape(x.shape)
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, gen)
        return self.ln_f(x).reshape(b, gh, gw, -1)
