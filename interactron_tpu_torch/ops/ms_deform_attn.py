"""Multi-scale deformable attention (Deformable DETR's MSDeformAttn core):
the CUDA kernels, their plain PyTorch versions and the autograd Function.

No TPU kernel is ported here: the JAX package has no deformable detector.
The kernels were added for `MODEL.BACKBONE: resnet50_deformable`
(models/deformable_detr.py), whose encoder and decoder spend most of their
time in this op (Zhu et al., ICLR 2021, arXiv:2010.04159).

    value     (N, S, H*D)         S = sum of the levels' H_l * W_l, level-major,
                                  each level row-major (y, x); its dtype is the
                                  output's (float32 or bfloat16)
    shapes    ((H_0, W_0), ...)   the levels' sizes, Python ints
    locations (N, Lq, H, L, P, 2) float32 (x, y) in [0, 1] of each level
    weights   (N, Lq, H, L, P)    float32, softmax-normalised over L*P
    out       (N, Lq, H*D)        sum over l, p of weight * bilinear(value_l, loc)

Bilinear sampling follows `grid_sample(..., align_corners=False,
padding_mode="zeros")`: pixel = loc * W_l - 0.5, and each of the four
corners outside the map reads zero. Locations and weights stay float32
(in bf16 a location on the 38-wide level loses its sub-pixel part), and
every sum is taken in float32.

The backward gives the three first-order gradients: dValue (summed in
float32 over every sample that read a value, then cast to value's dtype),
dLocations and dWeights (float32). It is not differentiable again: the
train step's second-order inner gradient is not ported for this op.

Every wrapper takes CPU (and meta) tensors through its plain version and
CUDA tensors through its kernel in `csrc/ms_deform_attn.cu`, built at first
use (ops/cuda_build.py). There is no fallback: a CUDA tensor the kernel does
not take raises. `launches` counts kernel launches; while the recorder is
on (utils/profiling.py) each launch is also recorded with its shapes and
counted in `msda.launches`, and each wrapper call is a span `msda.fwd` or
`msda.bwd`.
"""

import ctypes

import torch
from torch.autograd.function import once_differentiable

from interactron_tpu_torch.ops import cuda_build
from interactron_tpu_torch.utils import profiling

launches = {"msda_fwd": 0, "msda_bwd": 0}

MAX_LEVELS = 4  # the kernels take the levels' sizes as arguments
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_SHAPE_ARGS = [_I] * 8 + [_I] * 2 * MAX_LEVELS  # N, Lq, S, H, D, L, P, dtype; heights, widths
_ARGTYPES = {
    "msda_fwd": [_P] * 4 + _SHAPE_ARGS + [_P],
    "msda_bwd": [_P] * 7 + _SHAPE_ARGS + [_P],
}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _kernel(name):
    fn = getattr(cuda_build.load("ms_deform_attn"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, *args):
    """Call kernel `name` on the current stream and count the launch; while
    recording, keep its shapes (read from its own arguments) and count it in
    `msda.launches`."""
    err = _kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    profiling.count("msda.launches")
    pointers = len(_ARGTYPES[name]) - len(_SHAPE_ARGS) - 1
    n, lq, s, h, d, lv, p, dt = args[pointers:pointers + 8]
    profiling.record_msda(name, n, lq, s, h, d, lv, p, 4 if dt == _DTYPES[torch.float32] else 2)


def _shape_args(value, locations, shapes):
    n, s, hd = value.shape
    _, lq, h, lv, p, _ = locations.shape
    hs = [sh[0] for sh in shapes] + [0] * (MAX_LEVELS - lv)
    ws = [sh[1] for sh in shapes] + [0] * (MAX_LEVELS - lv)
    return [n, lq, s, h, hd // h, lv, p, _DTYPES[value.dtype], *hs, *ws]


def check(value, shapes, locations, weights):
    """Raise unless the operands are as the module's docstring states."""
    if value.dim() != 3 or locations.dim() != 6 or weights.dim() != 5:
        raise ValueError("expected value (N, S, H*D), locations (N, Lq, H, L, P, 2) and "
                         "weights (N, Lq, H, L, P)")
    n, s, hd = value.shape
    _, lq, h, lv, p, two = locations.shape
    if two != 2 or locations.shape[0] != n or weights.shape != locations.shape[:5]:
        raise ValueError(f"locations {tuple(locations.shape)} and weights "
                         f"{tuple(weights.shape)} do not match value {tuple(value.shape)}")
    if hd % h or len(shapes) != lv or sum(a * b for a, b in shapes) != s:
        raise ValueError(f"levels {shapes} and {h} heads do not match value "
                         f"{tuple(value.shape)}")
    if locations.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError("locations and weights must be float32")
    if value.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {value.dtype}; the kernels take float32 and "
                         "bfloat16")
    if any(x.device != value.device for x in (locations, weights)):
        raise ValueError("all operands must share one device")
    if value.device.type == "cuda" and lv > MAX_LEVELS:
        raise ValueError(f"{lv} levels; the kernels take at most {MAX_LEVELS}")


# ---------------------------------------------------------------- plain versions


def _corners(loc, h, w):
    """The four bilinear taps of (..., 2) locations on an h x w map, in the
    kernels' order (y0x0, y0x1, y1x0, y1x1): their flat indices (clamped
    into the map), their weights with zero for a tap outside it, and the
    fractions (fx, fy)."""
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    taps = []
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            taps.append((idx, torch.where(inside, wy * wx, 0.0), inside))
    return taps, fx, fy


def _levels(value, shapes, num_heads):
    """Each level's values as (N, H, H_l * W_l, D) float32."""
    n, s, hd = value.shape
    v = value.float().reshape(n, s, num_heads, hd // num_heads).transpose(1, 2)
    return torch.split(v, [a * b for a, b in shapes], dim=2)


def _gather(v, idx):
    """Rows `idx` (N, Lq, H, P) of v (N, H, HW, D) -> (N, Lq, H, P, D)."""
    n, lq, h, p = idx.shape
    flat = idx.permute(0, 2, 1, 3).reshape(n, h, lq * p, 1).expand(-1, -1, -1, v.shape[-1])
    return torch.gather(v, 2, flat).reshape(n, h, lq, p, -1).transpose(1, 2)


def ms_deform_attn_fwd_plain(value, shapes, locations, weights):
    """Plain version of the forward kernel, with indexing ops (it also runs
    on the meta device): (N, Lq, H*D) in value's dtype."""
    n, lq, h, _, _, _ = locations.shape
    out = 0.0
    for lvl, (v, (hh, ww)) in enumerate(zip(_levels(value, shapes, h), shapes)):
        taps, _, _ = _corners(locations[:, :, :, lvl], hh, ww)
        sampled = sum(_gather(v, idx) * wt[..., None] for idx, wt, _ in taps)
        out = out + (weights[:, :, :, lvl, :, None] * sampled).sum(3)
    return out.reshape(n, lq, -1).to(value.dtype)


def ms_deform_attn_bwd_plain(value, shapes, locations, weights, grad_out):
    """Plain version of the backward kernel: (dValue in value's dtype,
    dLocations, dWeights in float32), from the same per-tap terms."""
    n, lq, h, _, p, _ = locations.shape
    go = grad_out.float().reshape(n, lq, h, 1, -1)  # (N, Lq, H, 1, D)
    d_value, d_loc, d_w = [], [], []
    for lvl, (v, (hh, ww)) in enumerate(zip(_levels(value, shapes, h), shapes)):
        a = weights[:, :, :, lvl]
        taps, fx, fy = _corners(locations[:, :, :, lvl], hh, ww)
        fx, fy = fx[..., None], fy[..., None]
        # each tap's values, zero outside the map: (N, Lq, H, P, D)
        v00, v01, v10, v11 = (_gather(v, idx) * inside[..., None] for idx, _, inside in taps)
        sampled = sum(vc * wt[..., None] for vc, (_, wt, _) in zip((v00, v01, v10, v11), taps))
        d_w.append((go * sampled).sum(-1))
        ga = go * a[..., None]
        gx = (ga * ((1.0 - fy) * (v01 - v00) + fy * (v11 - v10))).sum(-1) * ww
        gy = (ga * ((1.0 - fx) * (v10 - v00) + fx * (v11 - v01))).sum(-1) * hh
        d_loc.append(torch.stack([gx, gy], -1))
        dv = torch.zeros_like(v)  # (N, H, HW, D)
        for idx, wt, _ in taps:
            contrib = (ga * wt[..., None]).transpose(1, 2).reshape(n, h, lq * p, -1)
            dv.scatter_add_(2, idx.transpose(1, 2).reshape(n, h, lq * p, 1).expand_as(contrib),
                            contrib)
        d_value.append(dv)
    dv = torch.cat(d_value, 2).transpose(1, 2).reshape(value.shape)
    return dv.to(value.dtype), torch.stack(d_loc, 3), torch.stack(d_w, 3)


# ---------------------------------------------------------------- wrappers


def ms_deform_attn_fwd(value, shapes, locations, weights, out=None):
    """(N, Lq, H*D) in value's dtype. On the card the kernel writes into
    `out` when given (contiguous, value's dtype): a CUDA graph's static
    buffer."""
    shapes = tuple(tuple(int(x) for x in sh) for sh in shapes)
    check(value, shapes, locations, weights)
    with profiling.span("msda.fwd"):
        if value.device.type != "cuda":
            return ms_deform_attn_fwd_plain(value, shapes, locations, weights)
        value, locations, weights = (x.contiguous() for x in (value, locations, weights))
        n, lq = locations.shape[:2]
        want = (n, lq, value.shape[2])
        if out is None:
            out = torch.empty(want, device=value.device, dtype=value.dtype)
        elif out.shape != want or out.dtype != value.dtype or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous {value.dtype} tensor of shape {want}")
        with torch.cuda.device(value.device):
            _launch("msda_fwd", value.data_ptr(), locations.data_ptr(), weights.data_ptr(),
                    out.data_ptr(), *_shape_args(value, locations, shapes))
        return out


def ms_deform_attn_bwd(value, shapes, locations, weights, grad_out):
    """(dValue, dLocations, dWeights) of `ms_deform_attn_fwd`."""
    shapes = tuple(tuple(int(x) for x in sh) for sh in shapes)
    check(value, shapes, locations, weights)
    with profiling.span("msda.bwd"):
        if value.device.type != "cuda":
            return ms_deform_attn_bwd_plain(value, shapes, locations, weights, grad_out)
        value, locations, weights = (x.contiguous() for x in (value, locations, weights))
        grad_out = grad_out.to(value.dtype).contiguous()
        d_value = torch.zeros(value.shape, device=value.device, dtype=torch.float32)
        d_loc = torch.empty_like(locations)
        d_w = torch.empty_like(weights)
        with torch.cuda.device(value.device):
            _launch("msda_bwd", value.data_ptr(), locations.data_ptr(), weights.data_ptr(),
                    grad_out.data_ptr(), d_value.data_ptr(), d_loc.data_ptr(), d_w.data_ptr(),
                    *_shape_args(value, locations, shapes))
        return d_value.to(value.dtype), d_loc, d_w


class MSDeformAttnFunction(torch.autograd.Function):
    """`ms_deform_attn_fwd` with `ms_deform_attn_bwd` as its backward (first
    order only)."""

    @staticmethod
    def forward(ctx, value, locations, weights, shapes):
        ctx.save_for_backward(value, locations, weights)
        ctx.shapes = shapes
        return ms_deform_attn_fwd(value, shapes, locations, weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        value, locations, weights = ctx.saved_tensors
        d_value, d_loc, d_w = ms_deform_attn_bwd(value, ctx.shapes, locations, weights, grad_out)
        return d_value, d_loc, d_w, None


def ms_deform_attn(value, shapes, locations, weights):
    """The op, differentiable once (see the module's docstring)."""
    return MSDeformAttnFunction.apply(value, locations, weights,
                                      tuple(tuple(int(x) for x in sh) for sh in shapes))
