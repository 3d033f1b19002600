"""Building blocks of the reference model: a frozen copy of the port's
models/layers.py with one formulation each and nothing else.

Parameters are fp32 in PyTorch layout (Linear weights (out, in), conv
weights OIHW); every module computes in its `dtype`, which the reference
leaves at fp32. Frozen tensors (the stem+layer1 kernels, every
FrozenBatchNorm) are buffers.

Per-episode weights: `Conv2d`, `Dense` and `LayerNorm` take, through
`functional_call`, either their shared weight or one with a leading axis
of E episodes, (E, *shape); activations are then (E*F, ...), episode-major.
A conv is a grouped conv with groups=E (a batched matmul when 1x1), a Dense
a batched matmul, a LayerNorm a broadcast affine.

Dropout is on exactly when a forward is given a generator: one int32 seed
a site, and the keep bits of attention.py's hash.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.attention import draw_seed, dropout_apply, packed_attention


def remat_call(unit, *args, gen=None):
    """unit(*args[, gen]): the reference keeps every activation."""
    return unit(*args) if gen is None else unit(*args, gen=gen)


def with_episodes(t, rank):
    """`t` with a leading episode axis: a weight of `rank` dims, shared
    (viewed as one episode's) or per-episode (E, ...), as it is."""
    return t.reshape(-1, *t.shape[t.dim() - rank:])


def by_episode(x, t):
    """(x, t) viewed to broadcast episode by episode: `t` is (E, *trailing),
    `x` episode-major (E*F, ...); x becomes (E, -1, *trailing) and t (E, 1,
    *trailing)."""
    return x.reshape(t.shape[0], -1, *t.shape[1:]), t[:, None]


def variance_scaling_(t, scale, fan_in, gen):
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def xavier_uniform_(t, fan_in, fan_out, gen):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(t, -bound, bound, generator=gen)


def _grouped_conv(x, w, stride, padding, dilation):
    """(E*F, C, H, W) frames and (E, O, C, kh, kw) kernels as one grouped
    conv with groups=E."""
    e = w.shape[0]
    b, c, h, wd = x.shape
    xg = x.reshape(e, b // e, c, h, wd).transpose(0, 1).reshape(b // e, e * c, h, wd)
    y = F.conv2d(xg, w.flatten(0, 1), None, stride, padding, dilation, groups=e)
    return y.reshape(b // e, e, -1, *y.shape[2:]).transpose(0, 1).reshape(b, -1, *y.shape[2:])


class Conv2d(nn.Module):
    """NCHW conv; 1x1 without padding as a matmul, anything else grouped."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0, dilation=1,
                 use_bias=False, frozen=False, dtype=torch.float32):
        super().__init__()
        self.kernel_size, self.stride, self.padding, self.dilation = (
            kernel_size, stride, padding, dilation)
        self.frozen = frozen
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
            variance_scaling_(self.weight, 2.0, self.weight[0].numel(), gen)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        x = x.to(self.dtype)
        w = with_episodes(self.weight.to(self.dtype), 4)
        e = w.shape[0]
        if self.kernel_size == 1 and self.padding == 0:
            if self.stride != 1:
                x = x[:, :, :: self.stride, :: self.stride]
            b, c, h, wd = x.shape
            y = torch.matmul(w[:, None, :, :, 0, 0], x.reshape(e, b // e, c, h * wd))
            y = y.reshape(b, -1, h, wd)
        else:
            y = _grouped_conv(x, w, self.stride, self.padding, self.dilation)
        if self.bias is not None:
            bias = with_episodes(self.bias.to(self.dtype), 1)
            y = (y.reshape(e, -1, *y.shape[1:]) + bias[:, None, :, None, None]).reshape(y.shape)
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
    """Linear layer with fp32 params and a compute dtype; `kernel_init` is
    "lecun", "xavier" or "normal02"."""

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
        x = x.to(self.dtype)
        w = with_episodes(self.weight.to(self.dtype), 2)  # (E, out, in)
        y = torch.bmm(x.reshape(w.shape[0], -1, x.shape[-1]), w.transpose(1, 2))
        y = y.reshape(*x.shape[:-1], w.shape[1])
        if self.bias is not None:
            yv, bv = by_episode(y, with_episodes(self.bias.to(self.dtype), 1))
            y = (yv + bv).reshape(y.shape)
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
        yv, wv = by_episode(y, with_episodes(self.weight, 1))
        return (yv * wv + with_episodes(self.bias, 1)[:, None]).reshape(y.shape).to(x.dtype)


class MLP(nn.Module):
    """num_layers - 1 ReLU layers and a linear output."""

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
    """Inverted dropout keyed by one seed drawn from `gen` and the element's
    (row, col) in x viewed as (rows, last dim)."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x, gen=None):
        if gen is None or self.rate == 0.0:
            return x
        cols = x.shape[-1]
        return dropout_apply(x, draw_seed(gen), self.rate, (1, x.numel() // cols, cols))


class MultiHeadAttention(nn.Module):
    """Separate q/k/v/out projections (with bias) and dense attention with
    an fp32 softmax over the packed head layout."""

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
