"""Fused attention on the packed (B, T, H*D) layout: the CUDA kernels, their
plain PyTorch versions and the autograd Function.

Counterpart of interactron_tpu/ops/flash_attention.py (`_fwd_kernel`,
`_bwd_merged_kernel`, `_flash`/`_flash_fwd`/`_flash_bwd`,
`flash_attention_bthd`). Head h of a packed tensor sits at columns
[h*D, (h+1)*D).

`flash_fwd` and `flash_bwd` take CPU tensors through `flash_fwd_plain` and
`flash_bwd_plain`, and CUDA tensors through the kernels in
`interactron_tpu_torch/csrc/` (built at first use, see ops/cuda_build.py).
There is no fallback: a CUDA tensor the kernel does not take raises. The
kernels read contiguous packed tensors; the wrappers call `.contiguous()`,
which is a no-op for the separate q/k/v projections of
models/layers.py::MultiHeadAttention.

`launches` counts kernel launches (never plain-version calls), so a run can
show that its attention went through the kernels.
"""

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from interactron_tpu_torch.ops import cuda_build

launches = {"flash_fwd": 0, "flash_bwd": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_I] * 6 + [_P],
    "flash_bwd": [_P] * 9 + [_I] * 6 + [_P],
}


def reset_launches():
    for name in launches:
        launches[name] = 0


def _kernel(name):
    fn = getattr(cuda_build.load(name), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _heads(x, h):
    """(B, T, H*D) -> (B, H, T, D) in fp32."""
    b, t, dim = x.shape
    return x.float().reshape(b, t, h, dim // h).transpose(1, 2)


def _packed(x):
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def flash_fwd_plain(q, k, v, num_heads):
    """Plain version of the forward kernel: (O in q's dtype, L (B, H, T) fp32)."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    logits = (qh @ kh.transpose(-1, -2)) * scale
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    o = (p.to(v.dtype).float() @ vh) / denom
    return _packed(o).to(q.dtype), (m + torch.log(denom)).squeeze(-1)


def flash_bwd_plain(q, k, v, o, lse, do, num_heads):
    """Plain version of the merged backward kernel: (dq, dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    qh, kh, vh, oh, doh = (_heads(x, num_heads) for x in (q, k, v, o, do))
    delta = (doh * oh).sum(-1, keepdim=True)
    p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - lse.unsqueeze(-1))
    dp = doh @ vh.transpose(-1, -2)
    dv = p.to(do.dtype).float().transpose(-1, -2) @ doh
    ds = (p * (dp - delta)).to(q.dtype).float()
    dk = (ds.transpose(-1, -2) @ qh) * scale
    dq = (ds @ kh) * scale
    return _packed(dq).to(q.dtype), _packed(dk).to(k.dtype), _packed(dv).to(v.dtype)


def _check(q, k, v, num_heads, rate, extra=()):
    if rate != 0.0:
        raise NotImplementedError(
            "attention dropout is not implemented yet: the kernels take rate == 0"
        )
    for x in (q, k, v, *extra):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError("q, k, v (and dO, O) must share one device and dtype")
        if x.dim() != 3:
            raise ValueError(f"expected packed (B, T, H*D) tensors, got {tuple(x.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}; kernels take float32 and bfloat16")
    b, t, dim = q.shape
    if dim % num_heads or dim // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {dim / num_heads} not in {_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != dim:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if t == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def flash_fwd(q, k, v, num_heads, rate=0.0):
    """O (B, T, H*D) in q's dtype and L (B, H, T) fp32 from packed q, k, v."""
    _check(q, k, v, num_heads, rate)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_heads)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, t, dim = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, num_heads, t), device=q.device, dtype=torch.float32)
    fn = _kernel("flash_fwd")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 b, t, k.shape[1], num_heads, dim // num_heads, _DTYPES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    launches["flash_fwd"] += 1
    return o, lse


def flash_bwd(q, k, v, o, lse, do, num_heads, rate=0.0):
    """(dq, dk, dv) of packed attention from the forward's residuals."""
    _check(q, k, v, num_heads, rate, extra=(o, do))
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, num_heads)
    if lse.dtype != torch.float32 or lse.shape != (q.shape[0], num_heads, q.shape[1]):
        raise ValueError("L must be (B, H, T) float32")
    q, k, v, do, lse = (x.contiguous() for x in (q, k, v, do, lse))
    b, t, dim = q.shape
    hd = dim // num_heads
    # delta = rowsum(dO * O) per head, outside the kernel as in the JAX package
    delta = (do.float() * o.float()).reshape(b, t, num_heads, hd).sum(-1)
    delta = delta.transpose(1, 2).contiguous()
    dq = torch.zeros((b, t, dim), device=q.device, dtype=torch.float32)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _kernel("flash_bwd")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, t, k.shape[1], num_heads, hd, _DTYPES[q.dtype],
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_bwd kernel launch failed: CUDA error {err}")
    launches["flash_bwd"] += 1
    return dq.to(q.dtype), dk, dv


class FlashAttention(torch.autograd.Function):
    """Packed attention, q (B, T, H*D) and k/v (B, S, H*D) -> (B, T, H*D),
    whose forward is `flash_fwd` and whose backward is `flash_bwd` (first
    order only): the counterpart of `flash_attention_bthd`."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, rate=0.0):
        o, lse = flash_fwd(q, k, v, num_heads, rate)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads = num_heads
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.num_heads)
        return dq, dk, dv, None, None
