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

Per-episode weights (what `jax.vmap` over episodes makes of the fast
weights): `Conv2d`, `Dense` and `LayerNorm` (so `MLP` and the attention's
projections) take, through `functional_call`, either their shared weight or
one with a leading axis of E episodes, (E, *shape). Activations then stay
(E*F, ...), episode-major: rows e*F .. e*F + F - 1 are episode e's F
frames. There is one path: a shared weight is the one-episode case
(`with_episodes`), whose F is the whole batch. A conv is a grouped conv
with groups=E over the episodes' channels (a batched matmul on the 1x1
path), a Dense a batched matmul, a LayerNorm a broadcast affine.

Conv formulations (<- the JAX package's im2col_convs and
episode_shift_convs). The port runs eagerly, so the JAX package's
trace-time scopes are run-time scopes here:
  * `episode_shift_convs()`: a trainable stride-1 3x3 conv with padding
    equal to its dilation runs as nine shifted batched GEMMs (`ShiftConv`),
    the partial products accumulated in fp32 and rounded once; bf16
    operands go to cuBLAS's bf16 GEMM with an fp32 output on the card;
  * `im2col_convs()`: every trainable conv with a kernel past 1x1 runs as
    `F.unfold` patches in (C, kh, kw) order against the flattened kernel,
    one batched GEMM;
  * otherwise the grouped conv above. Strided, frozen and 1x1 convs keep
    their path inside either scope; `conv_calls` counts the forwards of
    each formulation. The tasks choose the scopes (tasks/base.py).

`remat_call` runs a unit under non-reentrant activation checkpointing
(TRAINER.REMAT, the JAX package's nn.remat sites): the recomputation
replays the unit's dropout draws from a copy of its generator's state and
runs under the scopes of the forward.
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from interactron_tpu_torch.ops import attention
from interactron_tpu_torch.ops import flash_attention as fa
from interactron_tpu_torch.ops.attention import packed_attention
from interactron_tpu_torch.ops.flash_attention import draw_seed, dropout_apply
from interactron_tpu_torch.parallel.mesh import tp_copy, tp_gather
from interactron_tpu_torch.utils import cuda_graphs

_USE_IM2COL = False
_USE_SHIFT9 = False
conv_calls = {"matmul": 0, "shift": 0, "im2col": 0, "grouped": 0}


@contextlib.contextmanager
def _conv_flags(shift, im2col):
    global _USE_SHIFT9, _USE_IM2COL
    prev = _USE_SHIFT9, _USE_IM2COL
    _USE_SHIFT9, _USE_IM2COL = shift, im2col
    try:
        yield
    finally:
        _USE_SHIFT9, _USE_IM2COL = prev


def im2col_convs():
    """Scope: trainable k>1 convs as im2col GEMMs inside it."""
    return _conv_flags(_USE_SHIFT9, True)


def episode_shift_convs():
    """Scope: trainable stride-1 3x3 convs (padding == dilation) as nine
    shifted batched GEMMs inside it."""
    return _conv_flags(True, _USE_IM2COL)


def _scope_state():
    return _USE_SHIFT9, _USE_IM2COL, attention._flash_suppressed, fa._REMAT_DROPOUT


@contextlib.contextmanager
def _scopes(state):
    """Run under the conv scopes, the attention route and the dropout form
    of `state`, as `_scope_state` took it."""
    prev = attention._flash_suppressed
    attention._flash_suppressed = state[2]
    try:
        with _conv_flags(*state[:2]), fa.remat_dropout_scope(state[3]):
            yield
    finally:
        attention._flash_suppressed = prev


def remat_call(unit, *args, gen=None):
    """unit(*args), or unit(*args, gen=gen) with a generator, under
    non-reentrant activation checkpointing: only the unit's inputs are
    kept, and the backward runs it again. What checkpoint does not restore,
    the recomputation gets here: the tensors in the unit's parameters'
    places (`functional_call`'s fast weights), the forward's scopes, and
    its dropout draws, from copies of `gen`'s state on entry; `gen` is left
    where its own draws would leave it. So the masks, and the gradients,
    are those of a run without checkpointing."""
    tensors = unit.state_dict(keep_vars=True)
    state = None if gen is None else gen.get_state()
    scopes = _scope_state()
    end = []

    def run(*a):
        kw = {}
        if gen is not None:
            kw["gen"] = torch.Generator(gen.device).set_state(state)
        with _scopes(scopes):
            out = functional_call(unit, tensors, a, kw)
        if gen is not None and not end:
            end.append(kw["gen"].get_state())
        return out

    out = checkpoint(run, *args, use_reentrant=False)
    if gen is not None:
        gen.set_state(end[0])
    return out


def with_episodes(t, rank):
    """`t` with a leading episode axis: a weight of `rank` dims, shared
    (viewed as one episode's) or per-episode (E, ...), as it is."""
    return t.reshape(-1, *t.shape[t.dim() - rank:])


def by_episode(x, t):
    """(x, t) viewed to broadcast episode by episode: `t` is a per-episode
    tensor (E, *trailing), `x` is episode-major (E*F, ...) whose last
    dims broadcast against `trailing`; x becomes (E, -1, *trailing) and t
    (E, 1, *trailing). Reshape the result back to x's shape."""
    return x.reshape(t.shape[0], -1, *t.shape[1:]), t[:, None]


def variance_scaling_(t, scale, fan_in, gen):
    """Flax's variance_scaling(scale, "fan_in", "truncated_normal")."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def xavier_uniform_(t, fan_in, fan_out, gen):
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.init.uniform_(t, -bound, bound, generator=gen)


def _grouped_conv(x, w, stride, padding, dilation):
    """(E*F, C, H, W) frames and (E, O, C, kh, kw) kernels as one grouped
    conv with groups=E: (F, E*C, H, W), episode e's frames in group e."""
    e = w.shape[0]
    b, c, h, wd = x.shape
    xg = x.reshape(e, b // e, c, h, wd).transpose(0, 1).reshape(b // e, e * c, h, wd)
    y = F.conv2d(xg, w.flatten(0, 1), None, stride, padding, dilation, groups=e)
    return y.reshape(b // e, e, -1, *y.shape[2:]).transpose(0, 1).reshape(b, -1, *y.shape[2:])


def _gemm(a, b, acc=None):
    """Batched a @ b, or acc + a @ b into acc, with the products accumulated
    in fp32 (or wider) and returned in that type: bf16 or fp16 operands on
    the card through cuBLAS's half-precision GEMM with an fp32 output,
    elsewhere upcast."""
    dt = torch.promote_types(a.dtype, torch.float32)
    if a.is_cuda and a.dtype != dt:
        if acc is None:
            return torch.bmm(a, b, out_dtype=dt)
        return torch.baddbmm(acc, a, b, out_dtype=dt, out=acc)
    a, b = a.to(dt), b.to(dt)
    return torch.bmm(a, b) if acc is None else acc.baddbmm_(a, b)


def _grid(x, e, d, at):
    """(E*F, C, H, W) frames -> (E, F*Hp*Wp + 2d*(Wp + 1), C) zeros, Hp, Wp
    = H + 2d, W + 2d, channels last, with frame f's pixel (i, j) at row
    f*Hp*Wp + (i + at)*Wp + j + at; and the F*Hp*Wp rows an output covers.
    A 3x3 tap (ty, tx) at dilation d is then the row offset ty*d*Wp + tx*d,
    so its shifted input is a view whose rows start 16-byte aligned when C
    is a multiple of 8 (cuBLAS's fast GEMMs need that), and no copy."""
    b, c, h, w = x.shape
    hp, wp = h + 2 * d, w + 2 * d
    n = (b // e) * hp * wp
    g = x.new_zeros(e, n + 2 * d * (wp + 1), c)
    g[:, :n].view(e, b // e, hp, wp, c)[:, :, at:at + h, at:at + w] = (
        x.view(e, b // e, c, h, w).permute(0, 1, 3, 4, 2))
    return g, n, [ty * d * wp + tx * d for ty in range(3) for tx in range(3)]


class ShiftConv(torch.autograd.Function):
    """Stride-1 3x3 conv at dilation d (padding d) of (E*F, C, H, W) frames
    with (E, O, C, 3, 3) kernels as nine shifted GEMMs (E, N, C) @ (E, C,
    O) over the padded frames laid end to end (`_grid`), accumulated in
    fp32 and rounded once to x's dtype. N counts the padding's positions
    too, whose outputs are dropped. The backward is two more such products,
    the input gradient this Function with the kernels transposed and
    flipped and the kernel gradient `ShiftWgrad`, so it is differentiable
    again."""

    @staticmethod
    def forward(ctx, x, w, d):
        e, o = w.shape[:2]
        b, _, h, wd = x.shape
        g, n, offs = _grid(x, e, d, d)
        taps = w.flatten(3).permute(3, 0, 2, 1).contiguous()  # (9, E, C, O)
        acc = _gemm(g[:, offs[0]:offs[0] + n], taps[0])
        for t in range(1, 9):
            _gemm(g[:, offs[t]:offs[t] + n], taps[t], acc)
        y = acc.view(e, b // e, h + 2 * d, wd + 2 * d, o)[:, :, :h, :wd]
        ctx.save_for_backward(x, w)
        ctx.d = d
        return y.permute(0, 1, 4, 2, 3).reshape(b, o, h, wd).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = ShiftConv.apply(dy, w.transpose(1, 2).flip(-2, -1), ctx.d)
        if ctx.needs_input_grad[1]:
            dw = ShiftWgrad.apply(x, dy, ctx.d, w.shape[0])
        return dx, dw, None


class ShiftWgrad(torch.autograd.Function):
    """The per-episode kernel gradient of `ShiftConv`: for each tap, (E, O,
    N) output gradients @ (E, N, C) shifted inputs, accumulated in fp32 over
    the episode's frames and positions, -> (E, O, C, 3, 3) in x's dtype."""

    @staticmethod
    def forward(ctx, x, dy, d, e):
        gx, n, offs = _grid(x, e, d, d)
        gy = _grid(dy, e, d, 0)[0][:, :n].transpose(1, 2)
        dw = torch.stack([_gemm(gy, gx[:, off:off + n]) for off in offs], -1)
        ctx.save_for_backward(x, dy)
        ctx.d = d
        return dw.unflatten(-1, (3, 3)).to(x.dtype)

    @staticmethod
    def backward(ctx, gw):
        x, dy = ctx.saved_tensors
        gx = gdy = None
        if ctx.needs_input_grad[0]:
            gx = ShiftConv.apply(dy, gw.transpose(1, 2).flip(-2, -1), ctx.d)
        if ctx.needs_input_grad[1]:
            gdy = ShiftConv.apply(x, gw, ctx.d)
        return gx, gdy, None, None


def _im2col_conv(x, w, stride, padding, dilation):
    """Patches (E*F, C*kh*kw, L) in (C, kh, kw) order against the kernels
    flattened the same way: one (E, 1, O, C*kh*kw) @ (E, F, C*kh*kw, L)."""
    e, o, c, kh, kw = w.shape
    b, _, h, wd = x.shape
    cols = F.unfold(x, (kh, kw), dilation=dilation, padding=padding, stride=stride)
    y = torch.matmul(w.reshape(e, 1, o, c * kh * kw), cols.reshape(e, b // e, c * kh * kw, -1))
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (wd + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    return y.reshape(b, o, ho, wo)


class Conv2d(nn.Module):
    """NCHW conv with torch-style explicit padding, stride and dilation. A
    1x1 conv without padding runs as a matmul; a frozen conv keeps its
    kernel as a buffer. A per-episode kernel (E, O, I, kh, kw) convolves
    each episode's frames with its own kernel. A trainable k>1 conv takes
    the formulation of the scopes it runs in (`formulation`), and runs
    eagerly between the pieces of a CUDA graph (utils/cuda_graphs.py)."""

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
            variance_scaling_(self.weight, 2.0, self.weight[0].numel(), gen)  # he_normal
            if self.bias is not None:
                self.bias.zero_()

    def formulation(self):
        """"matmul", "shift", "im2col" or "grouped": the
        JAX package's order of precedence under the current scopes."""
        k, s, p, d = self.kernel_size, self.stride, self.padding, self.dilation
        if k == 1 and p == 0:
            return "matmul"
        if _USE_SHIFT9 and not self.frozen and k == 3 and s == 1 and p == d:
            return "shift"
        if _USE_IM2COL and not self.frozen:
            return "im2col"
        return "grouped"

    def forward(self, x):
        graph = cuda_graphs.capturing()
        if graph is not None and not self.frozen and self.kernel_size > 1:
            return graph.module(self, x)  # runs between the graph's pieces
        x = x.to(self.dtype)
        w = with_episodes(self.weight.to(self.dtype), 4)
        e = w.shape[0]
        form = self.formulation()
        conv_calls[form] += 1
        if form == "matmul":
            if self.stride != 1:
                x = x[:, :, :: self.stride, :: self.stride]
            b, c, h, wd = x.shape
            # (E, 1, O, C) @ (E, F, C, HW)
            y = torch.matmul(w[:, None, :, :, 0, 0], x.reshape(e, b // e, c, h * wd))
            y = y.reshape(b, -1, h, wd)
        elif form == "shift":
            y = ShiftConv.apply(x, w, self.dilation)
        elif form == "im2col":
            y = _im2col_conv(x, w, self.stride, self.padding, self.dilation)
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
    """Linear layer with fp32 params and a compute dtype. `kernel_init` names
    the JAX package's kernel initialiser: "lecun", "xavier" or "normal02".

    A class head split over tp (`parallel/mesh.py::shard_heads` sets
    `tp_group`) holds its rows of the weight, (out/tp, in) or per episode
    (E, out/tp, in): it computes its columns, gathers them over the group
    on the last axis and adds the whole bias."""

    def __init__(self, in_features, features, use_bias=True, dtype=torch.float32,
                 kernel_init="lecun"):
        super().__init__()
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.tp_group = None

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
        if self.tp_group is not None:
            x = tp_copy(x, self.tp_group)
        w = with_episodes(self.weight.to(self.dtype), 2)  # (E, out, in)
        y = torch.bmm(x.reshape(w.shape[0], -1, x.shape[-1]), w.transpose(1, 2))
        y = y.reshape(*x.shape[:-1], w.shape[1])
        if self.tp_group is not None:
            y = tp_gather(y, self.tp_group)
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
        yv, wv = by_episode(y, with_episodes(self.weight, 1))  # (E, d) affine
        return (yv * wv + with_episodes(self.bias, 1)[:, None]).reshape(y.shape).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over NCHW with fp32 statistics, cast back to the input
    dtype; its affine terms may be per-episode (E, C), as LayerNorm's."""

    def __init__(self, groups, features, eps=1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_weights(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        x32 = x.float().reshape(b, self.groups, -1)
        mean = x32.mean(-1, keepdim=True)
        var = (x32 - mean).square().mean(-1, keepdim=True)
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).reshape(b, c, h * w)
        wt, bs = with_episodes(self.weight, 1), with_episodes(self.bias, 1)
        e = wt.shape[0]
        y = y.reshape(e, b // e, c, h * w) * wt[:, None, :, None] + bs[:, None, :, None]
        return y.reshape(b, c, h, w).to(x.dtype)


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
    threshold, and the same bits on every device. Under MODEL.REMAT_DROPOUT
    (`dropout_apply`) the backward regenerates the mask instead of saving
    it."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x, gen=None):
        if gen is None or self.rate == 0.0:
            return x
        cols = x.shape[-1]
        return dropout_apply(x, draw_seed(gen), self.rate, (1, x.numel() // cols, cols))


class MultiHeadAttention(nn.Module):
    """Torch-style MHA with separate q/k/v/out projections (with bias) and
    an fp32 softmax over the packed head layout; attention dropout at
    `dropout_rate` when a generator is given. `flash` and `chunked` are
    ops/attention.py's switches (the task sets them from its config)."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.0, dtype=torch.float32,
                 kernel_init="xavier"):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.flash, self.chunked = True, False
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(embed_dim, embed_dim, dtype=dtype,
                                        kernel_init=kernel_init))

    def forward(self, q, k, v, gen=None):
        out = packed_attention(self.q_proj(q), self.k_proj(k), self.v_proj(v),
                               self.num_heads, self.dropout_rate, gen, self.flash,
                               self.chunked)
        return self.out_proj(out)
