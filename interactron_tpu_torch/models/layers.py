"""Building blocks shared by the backbone and the transformers (counterpart
of interactron_tpu/models/layers.py).

Parameters are fp32 in PyTorch layout (Linear weights (out, in), conv
weights OIHW) and every module computes in its `dtype`; LayerNorm
statistics and the attention softmax are fp32. Frozen reference tensors
(the stem+layer1 conv kernels, every FrozenBatchNorm) are buffers, so they
are neither parameters of the model nor part of the inner step.

Each module with weights has `init_weights(gen)`, which draws them from an
explicit `torch.Generator` with the JAX package's initialiser for that
module (the draws differ, the distributions match).

Dropout is on exactly when a forward is given a generator (`gen`), the
counterpart of JAX's `deterministic=False` with a dropout rng; modules stay
in eval mode throughout.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from interactron_tpu_torch.ops.attention import packed_attention
from interactron_tpu_torch.ops.flash_attention import draw_seed, dropout_mask


def variance_scaling_(t, scale, fan_in, gen):
    """Flax's variance_scaling(scale, "fan_in", "truncated_normal")."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def xavier_uniform_(t, fan_in, fan_out, gen):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(t, -bound, bound, generator=gen)


class Conv2d(nn.Module):
    """NCHW conv with torch-style explicit padding, stride and dilation. A
    1x1 conv without padding runs as a matmul; a frozen conv keeps its
    kernel as a buffer."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, dilation=1,
                 use_bias=False, frozen=False, dtype=torch.float32):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.dtype = dtype
        w = torch.zeros(out_ch, in_ch, kernel_size, kernel_size)
        b = torch.zeros(out_ch) if use_bias else None
        if frozen:
            self.register_buffer("weight", w)
            self.register_buffer("bias", b)
        else:
            self.weight = nn.Parameter(w)
            self.bias = None if b is None else nn.Parameter(b)

    def init_weights(self, gen):
        with torch.no_grad():
            variance_scaling_(self.weight, 2.0, self.weight[0].numel(), gen)  # he_normal
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype)
        if w.shape[-1] == 1 and self.padding == 0:
            if self.stride != 1:
                x = x[:, :, :: self.stride, :: self.stride]
            b, c, h, wd = x.shape
            y = torch.matmul(w[:, :, 0, 0], x.reshape(b, c, h * wd)).reshape(b, -1, h, wd)
        else:
            y = F.conv2d(x, w, None, self.stride, self.padding, self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[None, :, None, None]
        return y


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine terms, all buffers."""

    def __init__(self, features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def init_weights(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        bias = self.bias - self.running_mean * scale
        shape = (1, -1, 1, 1)
        return x * scale.to(self.dtype).view(shape) + bias.to(self.dtype).view(shape)


class Dense(nn.Module):
    """Linear layer with fp32 params and a compute dtype. `kernel_init` names
    the JAX package's kernel initialiser: "lecun", "xavier" or "normal02"."""

    def __init__(self, in_features, features, use_bias=True, dtype=torch.float32,
                 kernel_init="lecun"):
        super().__init__()
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def init_weights(self, gen):
        out_f, in_f = self.weight.shape
        with torch.no_grad():
            if self.kernel_init == "lecun":
                variance_scaling_(self.weight, 1.0, in_f, gen)
            elif self.kernel_init == "xavier":
                xavier_uniform_(self.weight, in_f, out_f, gen)
            else:
                nn.init.normal_(self.weight, 0.0, 0.02, generator=gen)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, cast back to the input dtype."""

    def __init__(self, features, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_weights(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class MLP(nn.Module):
    """num_layers - 1 ReLU layers and a linear output (DETR's FFN head)."""

    def __init__(self, in_dim, hidden_dim, out_dim, num_layers, dtype=torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"layer{i}", Dense(in_dim if i == 0 else hidden_dim,
                                               out_dim if last else hidden_dim, dtype=dtype))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x


class Dropout(nn.Module):
    """Inverted dropout (<- `_dropout_mask_apply`): the identity without a
    generator; with one, x * keep / (1 - rate), where keep is the kernels'
    hash keyed by one seed drawn from `gen` and the element's (row, col) in
    x viewed as (rows, last dim): P(keep) = 1 - rate with an integer
    threshold, and the same bits on every device."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x, gen=None):
        if gen is None or self.rate == 0.0:
            return x
        cols = x.shape[-1]
        keep = dropout_mask(draw_seed(gen), self.rate, (1, x.numel() // cols, cols), x.device)
        return x * keep.view(x.shape) * (1.0 / (1.0 - self.rate))


class MultiHeadAttention(nn.Module):
    """Torch-style MHA with separate q/k/v/out projections (with bias) and
    an fp32 softmax over the packed head layout; attention dropout at
    `dropout_rate` when a generator is given."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.0, dtype=torch.float32,
                 kernel_init="xavier"):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(embed_dim, embed_dim, dtype=dtype,
                                        kernel_init=kernel_init))

    def forward(self, q, k, v, gen=None):
        out = packed_attention(self.q_proj(q), self.k_proj(k), self.v_proj(v),
                               self.num_heads, self.dropout_rate, gen)
        return self.out_proj(out)
