"""Fused attention on the packed (B, T, H*D) layout: the CUDA kernels, their
plain PyTorch versions and the autograd Functions.

Counterpart of interactron_tpu/ops/flash_attention.py:
  * `flash_fwd` <- `_fwd_kernel` (O and the log-normaliser L);
  * `flash_bwd` <- `_bwd_merged_kernel` (dq, dk, dv);
  * `flash_dq` <- `_dq_kernel` and `flash_dkv` <- `_dkv_kernel_fullt` and
    `_dkv_kernel` (the split backward, one kernel for dq, one for dk/dv);
  * `flash_so` <- `_sov_merged_kernel` (the VJP of the backward, for the
    twice-differentiated meta inner loss);
  * `flash_so_row` <- `_sov_row_kernel` and `flash_so_col` <-
    `_sov_col_kernel` (the same VJP split: c_q, c_dO and the row statistics,
    then c_k, c_v);
  * `dropout_mask` <- `_mask_row_kernel` (the keep mask of a region);
  * `FlashAttention` <- `_flash` / `flash_attention_bthd` (first order);
  * `FlashAttentionSO` and `FlashGrads` <- `_flashso` / `_flash_grads` /
    `flash_attention_so_bthd` (second order).
Head h of a packed tensor sits at columns [h*D, (h+1)*D).

Formulation. As in the JAX package, environment variables read at call
time choose the backward's kernels (`formulation`): FLASH_BWD (`merged`,
the default, or anything else for split), SO_MERGED (`0` for split, merged
otherwise) and FLASH_DKV (`fullt`, the default, or anything else for
blocked). `flash_grads` and `flash_so_vjp` route on them. The TPU's two
dK/dV kernels differ only in how they use VMEM, so both FLASH_DKV values
take `flash_dkv`. In the split formulation every output element is written
by one CTA (no atomics), so its results are bitwise reproducible.

Every wrapper takes CPU tensors through its plain version and CUDA tensors
through its kernel in `interactron_tpu_torch/csrc/` (built at first use, see
ops/cuda_build.py). There is no fallback: a CUDA tensor the kernel does not
take raises. The kernels read contiguous packed tensors; the wrappers call
`.contiguous()`, and copy a bf16 TMA operand that does not start at a
16-byte aligned address (`_aligned`).

Dropout. The TPU kernels draw their keep masks from the TPU's PRNG keyed by
(seed, head, q-block, k-block) tiles, which ties every pass to one block
size. Here a keep bit is a pure function of (seed, b*H + h, row, col): a
murmur3-style hash built from 32-bit multiply-low, xor and shift only
(csrc/dropout.cuh), which `_hash_bits` repeats bit for bit in int64 torch
arithmetic. An element is kept iff its hash >= min(int(rate * 2^32),
2^32 - 1), so P(keep) = 1 - rate to 2^-32, and masks agree between the
plain versions and the kernels, across the forward, backward and
second-order passes, at any tiling and on any device. Kept probabilities
are scaled by 1 / (1 - rate) after the softmax's denominator is taken.

`launches` counts kernel launches (never plain-version calls), so a run can
show that its attention went through the kernels.
"""

import contextlib
import ctypes
import math
import os

import torch
from torch.autograd.function import once_differentiable

from interactron_tpu_torch.ops import cuda_build
from interactron_tpu_torch.utils import profiling

launches = {"flash_fwd": 0, "flash_bwd": 0, "flash_dq": 0, "flash_dkv": 0, "flash_so": 0,
            "flash_so_row": 0, "flash_so_col": 0, "dropout_mask": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_DROP = [_U, _U, _F, _I]  # seed, keep threshold, 1 / (1 - rate), dropout on
_ARGTYPES = {
    "flash_fwd": [_P] * 5 + [_I] * 6 + _DROP + [_P],
    "flash_bwd": [_P] * 9 + [_I] * 6 + _DROP + [_P],
    "flash_dq": [_P] * 7 + [_I] * 6 + _DROP + [_P],
    "flash_dkv": [_P] * 8 + [_I] * 6 + _DROP + [_P],
    "flash_so": [_P] * 13 + [_I] * 6 + _DROP + [_P],
    "flash_so_row": [_P] * 13 + [_I] * 6 + _DROP + [_P],
    "flash_so_col": [_P] * 13 + [_I] * 6 + _DROP + [_P],
    "dropout_mask": [_P, _U, _U] + [_I] * 6 + [_P],
}

_M32 = 0xFFFFFFFF
# hash constants, the same as csrc/dropout.cuh
_SEED_SALT = 0x6A09E667
_MIX_BH = 0x9E3779B9
_MIX_ROW = 0x85EBCA77
_MIX_COL = 0xC2B2AE3D
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35


def reset_launches():
    for name in launches:
        launches[name] = 0


def formulation():
    """The backward's formulation from the environment, read at each call
    with the JAX package's defaults and meanings: {"bwd": "merged" or
    "split", "dkv": "fullt" or "blocked", "so": "merged" or "split"}."""
    return {"bwd": "merged" if os.environ.get("FLASH_BWD", "merged") == "merged" else "split",
            "dkv": "fullt" if os.environ.get("FLASH_DKV", "fullt") == "fullt" else "blocked",
            "so": "merged" if os.environ.get("SO_MERGED", "1") != "0" else "split"}


def _kernel(name):
    fn = getattr(cuda_build.load(name), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, *args):
    """Call kernel `name` on the current stream and count the launch; while
    the recorder is on (utils/profiling.py), an attention kernel's launch
    is also recorded with its shapes, read from its own arguments."""
    err = _kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1
    if profiling.recording() and name != "dropout_mask":
        # the six ints after the pointers: B, T, S, H, D, dtype; then the
        # dropout arguments, whose scale is 1 / (1 - rate)
        i = _ARGTYPES[name].index(_I)
        b, t, s, h, d, dt = args[i:i + 6]
        scale, on = args[i + 8], args[i + 9]
        profiling.record_launch(name, b, t, s, h, d, 4 if dt == _DTYPES[torch.float32] else 2,
                                1.0 - 1.0 / scale if on else 0.0)


# ---------------------------------------------------------------- dropout


def draw_seed(gen):
    """An int32 dropout seed from the caller's generator (<- `_seed_rate`)."""
    return int(torch.randint(0, 2**31 - 1, (), generator=gen))


def keep_threshold(rate):
    """Integer keep threshold: an element is kept iff its 32-bit hash >= it."""
    return min(int(rate * 4294967296.0), 4294967295)


def _drop_args(rate, seed):
    return [seed & _M32, keep_threshold(rate), 1.0 / (1.0 - rate), int(rate > 0.0)]


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    split in 16-bit halves so no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX2)
    return h ^ (h >> 16)


def _hash_bits(seed, bh, rows, cols):
    """32-bit hashes (as int64) of every (bh, row, col) of three index vectors."""
    h0 = _fmix((((seed & _M32) ^ _SEED_SALT) + _mul32(bh, _MIX_BH)) & _M32)
    h1 = _fmix(h0[:, None] ^ _mul32(rows, _MIX_ROW)[None, :])
    return _fmix(h1[:, :, None] ^ _mul32(cols, _MIX_COL)[None, None, :])


def dropout_mask_plain(seed, rate, shape, offsets=(0, 0, 0), device="cpu"):
    """Plain version of the mask kernel: the uint8 keep mask of the region
    `shape` = (n_bh, n_rows, n_cols) starting at `offsets` = (bh0, row0, col0)."""
    idx = [torch.arange(o, o + n, device=device, dtype=torch.int64)
           for o, n in zip(offsets, shape)]
    return (_hash_bits(seed, *idx) >= keep_threshold(rate)).to(torch.uint8)


def dropout_mask(seed, rate, shape, device, offsets=(0, 0, 0)):
    """uint8 keep mask (1 = kept) of a (n_bh, n_rows, n_cols) region at
    `offsets`, on `device`: the plain version on the CPU, the kernel on CUDA."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    if len(shape) != 3 or len(offsets) != 3 or min(shape) <= 0 or min(offsets) < 0:
        raise ValueError(f"bad region {shape} at {offsets}")
    device = torch.device(device)
    if device.type == "cpu":
        return dropout_mask_plain(seed, rate, shape, offsets, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty(shape, device=device, dtype=torch.uint8)
    with torch.cuda.device(device):
        _launch("dropout_mask", out.data_ptr(), seed & _M32, keep_threshold(rate),
                *shape, *offsets)
    return out


# MODEL.REMAT_DROPOUT (<- models/layers.py::set_remat_dropout): on by
# default as in JAX; a task enters `remat_dropout_scope` with its config's
# value around each pass of its modules
_REMAT_DROPOUT = True


@contextlib.contextmanager
def remat_dropout_scope(enabled):
    """Scope: dropout inside it saves no mask (`DropoutApply`) when
    `enabled`, else saves its mask for the backward."""
    global _REMAT_DROPOUT
    prev, _REMAT_DROPOUT = _REMAT_DROPOUT, bool(enabled)
    try:
        yield
    finally:
        _REMAT_DROPOUT = prev


def _apply_mask(x, seed, rate, region, offsets):
    keep = dropout_mask(seed, rate, region, x.device, offsets)
    return x * keep.view(x.shape) * (1.0 / (1.0 - rate))


class DropoutApply(torch.autograd.Function):
    """x * keep / (1 - rate) that saves no mask (<- the jax.checkpoint of
    `_dropout_mask_apply`): keep is the mask of `region` = (n_bh, rows,
    cols) at `offsets`, x viewed as that region. The backward regenerates
    the mask from the seed by applying this Function to dy, so it is
    differentiable again, and each order of differentiation launches the
    mask once more."""

    @staticmethod
    def forward(ctx, x, seed, rate, region, offsets):
        ctx.mask = (seed, rate, region, offsets)
        return _apply_mask(x, seed, rate, region, offsets)

    @staticmethod
    def backward(ctx, dy):
        return DropoutApply.apply(dy, *ctx.mask), None, None, None, None


def dropout_apply(x, seed, rate, region, offsets=(0, 0, 0)):
    """Inverted dropout of x with the mask of `region` at `offsets` (x has
    its size): through `DropoutApply` under MODEL.REMAT_DROPOUT, else with
    the mask saved for the backward. The values are the same either way."""
    region, offsets = tuple(region), tuple(offsets)
    if _REMAT_DROPOUT:
        return DropoutApply.apply(x, seed, rate, region, offsets)
    return _apply_mask(x, seed, rate, region, offsets)


def _head_mask(seed, rate, b, h, t, s, device):
    """Keep mask of packed attention as (B, H, T, S) bool, keyed (b*H+h, row, col)."""
    return dropout_mask_plain(seed, rate, (b * h, t, s), device=device).view(b, h, t, s).bool()


# ---------------------------------------------------------------- plain versions


def _heads(x, h):
    """(B, T, H*D) -> (B, H, T, D) in fp32."""
    b, t, dim = x.shape
    return x.float().reshape(b, t, h, dim // h).transpose(1, 2)


def _packed(x):
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def flash_fwd_plain(q, k, v, num_heads, rate=0.0, seed=0):
    """Plain version of the forward kernel: (O in q's dtype, L (B, H, T) fp32)."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    logits = (qh @ kh.transpose(-1, -2)) * scale
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(-1, keepdim=True)
    if rate > 0.0:
        b, h, t, s = p.shape
        p = torch.where(_head_mask(seed, rate, b, h, t, s, q.device), p * (1.0 / (1.0 - rate)), 0.0)
    o = (p.to(v.dtype).float() @ vh) / denom
    return _packed(o).to(q.dtype), (m + torch.log(denom)).squeeze(-1)


def _bwd_tiles(q, k, v, o, lse, do, num_heads, rate, seed):
    """The (B, H, T, S) tiles of the first-order backward, shared by the
    merged and the split plain versions: (scale, q, k, dO heads in fp32,
    the dropped P rounded to dO's dtype, dS rounded to q's dtype)."""
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    qh, kh, vh, oh, doh = (_heads(x, num_heads) for x in (q, k, v, o, do))
    delta = (doh * oh).sum(-1, keepdim=True)
    p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - lse.unsqueeze(-1))
    dp = doh @ vh.transpose(-1, -2)
    pd = p
    if rate > 0.0:
        b, h, t, s = p.shape
        keep = _head_mask(seed, rate, b, h, t, s, q.device)
        inv = 1.0 / (1.0 - rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds = (p * (dp - delta)).to(q.dtype).float()
    return scale, qh, kh, doh, pd.to(do.dtype).float(), ds


def flash_bwd_plain(q, k, v, o, lse, do, num_heads, rate=0.0, seed=0):
    """Plain version of the merged backward kernel: (dq, dk, dv)."""
    scale, qh, kh, doh, pd, ds = _bwd_tiles(q, k, v, o, lse, do, num_heads, rate, seed)
    dv = pd.transpose(-1, -2) @ doh
    dk = (ds.transpose(-1, -2) @ qh) * scale
    dq = (ds @ kh) * scale
    return _packed(dq).to(q.dtype), _packed(dk).to(k.dtype), _packed(dv).to(v.dtype)


def flash_dq_plain(q, k, v, o, lse, do, num_heads, rate=0.0, seed=0):
    """Plain version of the dq kernel: dq = scale * dS K in q's dtype."""
    scale, _, kh, _, _, ds = _bwd_tiles(q, k, v, o, lse, do, num_heads, rate, seed)
    return _packed((ds @ kh) * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, o, lse, do, num_heads, rate=0.0, seed=0):
    """Plain version of the dK/dV kernel: (dk, dv), dK from the raw q times
    the scale (`_dkv_kernel`'s form; `_dkv_kernel_fullt` scales q first,
    which agrees to rounding)."""
    scale, qh, _, doh, pd, ds = _bwd_tiles(q, k, v, o, lse, do, num_heads, rate, seed)
    dk = (ds.transpose(-1, -2) @ qh) * scale
    dv = pd.transpose(-1, -2) @ doh
    return _packed(dk).to(k.dtype), _packed(dv).to(v.dtype)


def _so_tiles(q, k, v, do, a, bc, c, lse, delta, num_heads, rate, seed, stats=None):
    """The (B, H, T, S) tiles of the second-order backward (math of
    `_sov_merged_kernel`), shared by the merged and the split plain versions.
    `stats` = (g_D, s_gp), each (B, H, T), are the row statistics when the
    row half has formed them; without them they are formed here. Returns
    the scale, the operand heads in fp32, g_S, dS, the dropped P and g_dp
    rounded to the operand dtype (where the Pallas kernels round before
    each product), and g_D, s_gp as (B, H, T, 1)."""
    dt = q.dtype
    rnd = lambda x: x.to(dt).float()
    scale = 1.0 / math.sqrt(q.shape[-1] // num_heads)
    heads = [_heads(x, num_heads) for x in (q, k, v, do, a, bc, c)]
    qh, kh, vh, doh, ah, bh, ch = heads
    p = torch.exp((qh @ kh.transpose(-1, -2)) * scale - lse.unsqueeze(-1))
    dp = doh @ vh.transpose(-1, -2)
    g_ds = (ah @ kh.transpose(-1, -2) + qh @ bh.transpose(-1, -2)) * scale
    g_p1 = doh @ ch.transpose(-1, -2)
    pd = p
    if rate > 0.0:
        b, h, t, s = p.shape
        keep = _head_mask(seed, rate, b, h, t, s, q.device)
        inv = 1.0 / (1.0 - rate)
        dp = torch.where(keep, dp * inv, 0.0)
        g_p1 = torch.where(keep, g_p1 * inv, 0.0)
        pd = torch.where(keep, p * inv, 0.0)
    e = dp - delta.unsqueeze(-1)
    ds = p * e
    if stats is None:
        g_d = -(p * g_ds).sum(-1, keepdim=True)
    else:
        g_d = stats[0].unsqueeze(-1)
    g_p = g_p1 + g_ds * e + g_d * dp
    g_dp = p * (g_ds + g_d)
    if rate > 0.0:
        g_dp = torch.where(keep, g_dp * inv, 0.0)
    s_gp = (p * g_p).sum(-1, keepdim=True) if stats is None else stats[1].unsqueeze(-1)
    g_s = p * (g_p - s_gp)
    return scale, heads, rnd(g_s), rnd(ds), rnd(pd), rnd(g_dp), g_d, s_gp


def flash_so_plain(q, k, v, do, a, bc, c, lse, delta, num_heads, rate=0.0, seed=0):
    """Plain version of the second-order kernel: the cotangents (c_q, c_k,
    c_v, c_dO) of (q, k, v, dO) given the cotangents (A, Bc, C) of the
    backward's (dq, dk, dv)."""
    scale, (qh, kh, vh, doh, ah, bh, ch), g_s, ds, pd, g_dp, _, _ = _so_tiles(
        q, k, v, do, a, bc, c, lse, delta, num_heads, rate, seed)
    cq = (g_s @ kh + ds @ bh) * scale
    cdo = pd @ ch + g_dp @ vh
    ck = (g_s.transpose(-1, -2) @ qh + ds.transpose(-1, -2) @ ah) * scale
    cv = g_dp.transpose(-1, -2) @ doh
    return tuple(_packed(x).to(q.dtype) for x in (cq, ck, cv, cdo))


def flash_so_row_plain(q, k, v, do, a, bc, c, lse, delta, num_heads, rate=0.0, seed=0):
    """Plain version of the row half of the second-order kernel pair:
    (c_q, c_dO) in q's dtype and the row statistics g_D = -rowsum(P*g_dS)
    and s_gp = rowsum(P*g_P), each (B, H, T) fp32."""
    scale, (_, kh, vh, _, _, bh, ch), g_s, ds, pd, g_dp, g_d, s_gp = _so_tiles(
        q, k, v, do, a, bc, c, lse, delta, num_heads, rate, seed)
    cq = (g_s @ kh + ds @ bh) * scale
    cdo = pd @ ch + g_dp @ vh
    return _packed(cq).to(q.dtype), _packed(cdo).to(q.dtype), g_d.squeeze(-1), s_gp.squeeze(-1)


def flash_so_col_plain(q, k, v, do, a, bc, c, lse, delta, g_d, s_gp, num_heads, rate=0.0,
                       seed=0):
    """Plain version of the column half: (c_k, c_v) in q's dtype from the
    row half's statistics g_D and s_gp."""
    scale, (qh, _, _, doh, ah, _, _), g_s, ds, _, g_dp, _, _ = _so_tiles(
        q, k, v, do, a, bc, c, lse, delta, num_heads, rate, seed, stats=(g_d, s_gp))
    ck = (g_s.transpose(-1, -2) @ qh + ds.transpose(-1, -2) @ ah) * scale
    cv = g_dp.transpose(-1, -2) @ doh
    return _packed(ck).to(q.dtype), _packed(cv).to(q.dtype)


# ---------------------------------------------------------------- wrappers


def _check(q, k, v, num_heads, rate, q_like=(), k_like=()):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} not in [0, 1)")
    for x in (q, k, v, *q_like, *k_like):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError("all attention operands must share one device and dtype")
        if x.dim() != 3:
            raise ValueError(f"expected packed (B, T, H*D) tensors, got {tuple(x.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}; kernels take float32 and bfloat16")
    b, t, dim = q.shape
    if dim % num_heads or dim // num_heads not in _HEAD_DIMS:
        raise ValueError(f"head dim {dim / num_heads} not in {_HEAD_DIMS}")
    if k.shape[0] != b or k.shape[2] != dim or any(x.shape != k.shape for x in (v, *k_like)):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if any(x.shape != q.shape for x in q_like):
        raise ValueError("dO/O/A must have q's shape")
    if t == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def _aligned(x):
    """`x` contiguous at a 16-byte aligned address, as the bf16 kernels'
    TMA tensor maps require (a view into a larger buffer may start between
    16-byte boundaries; it is then copied)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_rows(x, q, num_heads, name):
    if x.dtype != torch.float32 or x.shape != (q.shape[0], num_heads, q.shape[1]):
        raise ValueError(f"{name} must be (B, H, T) float32")


def flash_fwd(q, k, v, num_heads, rate=0.0, seed=0, out=None):
    """O (B, T, H*D) in q's dtype and L (B, H, T) fp32 from packed q, k, v,
    with attention-probability dropout at `rate` keyed by `seed`. On the
    card the kernel writes O into `out` when given (contiguous, 16-byte
    aligned, q's shape and dtype): a CUDA graph's static buffer."""
    _check(q, k, v, num_heads, rate)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_heads, rate, seed)
    q, k, v = (_aligned(x) for x in (q, k, v))
    b, t, dim = q.shape
    if out is None:
        o = torch.empty_like(q)
    elif (out.shape != q.shape or out.dtype != q.dtype or out.device != q.device
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError("out must be a contiguous, 16-byte aligned tensor like q")
    else:
        o = out
    lse = torch.empty((b, num_heads, t), device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, t, k.shape[1], num_heads, dim // num_heads,
                _DTYPES[q.dtype], *_drop_args(rate, seed))
    return o, lse


def _delta(do, o, num_heads):
    """rowsum(dO * O) per head, (B, H, T) fp32, outside the kernels as in the
    JAX package."""
    b, t, dim = o.shape
    d = (do.float() * o.float()).reshape(b, t, num_heads, dim // num_heads).sum(-1)
    return d.transpose(1, 2).contiguous()


def flash_bwd(q, k, v, o, lse, do, num_heads, rate=0.0, seed=0):
    """(dq, dk, dv) of packed attention from the forward's residuals."""
    _check(q, k, v, num_heads, rate, q_like=(o, do))
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, num_heads, rate, seed)
    _check_rows(lse, q, num_heads, "L")
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    lse = lse.contiguous()
    b, t, dim = q.shape
    delta = _delta(do, o, num_heads)
    dq = torch.zeros((b, t, dim), device=q.device, dtype=torch.float32)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                b, t, k.shape[1], num_heads, dim // num_heads, _DTYPES[q.dtype],
                *_drop_args(rate, seed))
    return dq.to(q.dtype), dk, dv


def _split_operands(q, k, v, o, lse, do, num_heads):
    """The CUDA operands of the split backward's two kernels, prepared once
    for both: (q, k, v, dO aligned for TMA, L contiguous, delta)."""
    _check_rows(lse, q, num_heads, "L")
    q, k, v, do = (_aligned(x) for x in (q, k, v, do))
    return q, k, v, do, lse.contiguous(), _delta(do, o, num_heads)


def _dq_launch(q, k, v, do, lse, delta, num_heads, rate, seed):
    b, t, dim = q.shape
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch("flash_dq", *(x.data_ptr() for x in (q, k, v, do, lse, delta, dq)),
                b, t, k.shape[1], num_heads, dim // num_heads, _DTYPES[q.dtype],
                *_drop_args(rate, seed))
    return dq


def _dkv_launch(q, k, v, do, lse, delta, num_heads, rate, seed):
    b, t, dim = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch("flash_dkv", *(x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)),
                b, t, k.shape[1], num_heads, dim // num_heads, _DTYPES[q.dtype],
                *_drop_args(rate, seed))
    return dk, dv


def flash_dq(q, k, v, o, lse, do, num_heads, rate=0.0, seed=0):
    """dq of packed attention in q's dtype, one CTA per query tile (the
    split backward's first half)."""
    _check(q, k, v, num_heads, rate, q_like=(o, do))
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, o, lse, do, num_heads, rate, seed)
    return _dq_launch(*_split_operands(q, k, v, o, lse, do, num_heads), num_heads, rate, seed)


def flash_dkv(q, k, v, o, lse, do, num_heads, rate=0.0, seed=0):
    """(dk, dv) of packed attention in k's dtype, one CTA per key tile (the
    split backward's second half, for both values of FLASH_DKV)."""
    _check(q, k, v, num_heads, rate, q_like=(o, do))
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, o, lse, do, num_heads, rate, seed)
    return _dkv_launch(*_split_operands(q, k, v, o, lse, do, num_heads), num_heads, rate, seed)


def flash_grads(q, k, v, o, lse, do, num_heads, rate=0.0, seed=0):
    """(dq, dk, dv) by the formulation FLASH_BWD selects: `flash_bwd` when
    merged, `flash_dq` then `flash_dkv` when split (on the card, with delta
    and the aligned operands prepared once for both)."""
    if formulation()["bwd"] == "merged":
        return flash_bwd(q, k, v, o, lse, do, num_heads, rate, seed)
    _check(q, k, v, num_heads, rate, q_like=(o, do))
    if q.device.type == "cpu":
        return (flash_dq_plain(q, k, v, o, lse, do, num_heads, rate, seed),
                *flash_dkv_plain(q, k, v, o, lse, do, num_heads, rate, seed))
    ops = _split_operands(q, k, v, o, lse, do, num_heads)
    return (_dq_launch(*ops, num_heads, rate, seed), *_dkv_launch(*ops, num_heads, rate, seed))


def _so_operands(q, k, v, do, a, bc, c, lse, delta):
    """The CUDA operands of the second-order kernels: the seven packed
    tensors aligned for the bf16 kernels' TMA maps, L and D contiguous."""
    return (*(_aligned(x) for x in (q, k, v, do, a, bc, c)), lse.contiguous(), delta.contiguous())


def flash_so(q, k, v, do, a, bc, c, lse, delta, num_heads, rate=0.0, seed=0):
    """(c_q, c_k, c_v, c_dO): the VJP of the attention backward for the
    cotangents (A, Bc, C) of (dq, dk, dv); L and D = rowsum(dO * O) are
    (B, H, T) fp32. Outputs in q's dtype."""
    _check(q, k, v, num_heads, rate, q_like=(do, a), k_like=(bc, c))
    _check_rows(lse, q, num_heads, "L")
    _check_rows(delta, q, num_heads, "D")
    if q.device.type == "cpu":
        return flash_so_plain(q, k, v, do, a, bc, c, lse, delta, num_heads, rate, seed)
    q, k, v, do, a, bc, c, lse, delta = _so_operands(q, k, v, do, a, bc, c, lse, delta)
    b, t, dim = q.shape
    cq = torch.empty_like(q)
    cdo = torch.empty_like(q)
    ck = torch.zeros(k.shape, device=q.device, dtype=torch.float32)
    cv = torch.zeros(k.shape, device=q.device, dtype=torch.float32)
    with torch.cuda.device(q.device):
        _launch("flash_so", *(x.data_ptr() for x in (q, k, v, do, a, bc, c, lse, delta,
                                                      cq, cdo, ck, cv)),
                b, t, k.shape[1], num_heads, dim // num_heads, _DTYPES[q.dtype],
                *_drop_args(rate, seed))
    return cq, ck.to(q.dtype), cv.to(q.dtype), cdo


def flash_so_row(q, k, v, do, a, bc, c, lse, delta, num_heads, rate=0.0, seed=0):
    """The row half of the split second-order backward: (c_q, c_dO) in q's
    dtype and the row statistics (g_D, s_gp), each (B, H, T) fp32, that
    `flash_so_col` reads."""
    _check(q, k, v, num_heads, rate, q_like=(do, a), k_like=(bc, c))
    _check_rows(lse, q, num_heads, "L")
    _check_rows(delta, q, num_heads, "D")
    if q.device.type == "cpu":
        return flash_so_row_plain(q, k, v, do, a, bc, c, lse, delta, num_heads, rate, seed)
    q, k, v, do, a, bc, c, lse, delta = _so_operands(q, k, v, do, a, bc, c, lse, delta)
    b, t, dim = q.shape
    cq = torch.empty_like(q)
    cdo = torch.empty_like(q)
    g_d = torch.empty_like(lse)
    s_gp = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        _launch("flash_so_row", *(x.data_ptr() for x in (q, k, v, do, a, bc, c, lse, delta,
                                                          cq, cdo, g_d, s_gp)),
                b, t, k.shape[1], num_heads, dim // num_heads, _DTYPES[q.dtype],
                *_drop_args(rate, seed))
    return cq, cdo, g_d, s_gp


def flash_so_col(q, k, v, do, a, bc, c, lse, delta, g_d, s_gp, num_heads, rate=0.0, seed=0):
    """The column half: (c_k, c_v) in q's dtype from `flash_so_row`'s row
    statistics, one CTA per key tile."""
    _check(q, k, v, num_heads, rate, q_like=(do, a), k_like=(bc, c))
    for x, name in ((lse, "L"), (delta, "D"), (g_d, "g_D"), (s_gp, "s_gp")):
        _check_rows(x, q, num_heads, name)
    if q.device.type == "cpu":
        return flash_so_col_plain(q, k, v, do, a, bc, c, lse, delta, g_d, s_gp, num_heads,
                                  rate, seed)
    q, k, v, do, a, bc, c, lse, delta = _so_operands(q, k, v, do, a, bc, c, lse, delta)
    g_d, s_gp = g_d.contiguous(), s_gp.contiguous()
    b, t, dim = q.shape
    ck = torch.empty_like(k)
    cv = torch.empty_like(k)
    with torch.cuda.device(q.device):
        _launch("flash_so_col", *(x.data_ptr() for x in (q, k, v, do, a, bc, c, lse, delta,
                                                          g_d, s_gp, ck, cv)),
                b, t, k.shape[1], num_heads, dim // num_heads, _DTYPES[q.dtype],
                *_drop_args(rate, seed))
    return ck, cv


def flash_so_vjp(q, k, v, do, a, bc, c, lse, delta, num_heads, rate=0.0, seed=0):
    """(c_q, c_k, c_v, c_dO) by the formulation SO_MERGED selects:
    `flash_so` when merged, `flash_so_row` then `flash_so_col` when split
    (both on the current stream, so the column half reads finished
    statistics)."""
    if formulation()["so"] == "merged":
        return flash_so(q, k, v, do, a, bc, c, lse, delta, num_heads, rate, seed)
    cq, cdo, g_d, s_gp = flash_so_row(q, k, v, do, a, bc, c, lse, delta, num_heads, rate, seed)
    ck, cv = flash_so_col(q, k, v, do, a, bc, c, lse, delta, g_d, s_gp, num_heads, rate, seed)
    return cq, ck, cv, cdo


# ---------------------------------------------------------------- autograd


class FlashAttention(torch.autograd.Function):
    """Packed attention, q (B, T, H*D) and k/v (B, S, H*D) -> (B, T, H*D),
    whose forward is `flash_fwd` and whose backward is `flash_grads` (first
    order only): the counterpart of `flash_attention_bthd`."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, rate=0.0, seed=0):
        o, lse = flash_fwd(q, k, v, num_heads, rate, seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (num_heads, rate, seed)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_grads(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None


class FlashGrads(torch.autograd.Function):
    """The attention backward as a function of its own, (q, k, v, dO) ->
    (dq, dk, dv) (<- `_flash_grads`): its forward recomputes (O, L) and runs
    `flash_grads`, its backward recomputes (O, L) and D and runs
    `flash_so_vjp`. Third order is not defined."""

    @staticmethod
    def forward(ctx, q, k, v, do, num_heads, rate, seed):
        o, lse = flash_fwd(q, k, v, num_heads, rate, seed)
        ctx.save_for_backward(q, k, v, do)
        ctx.args = (num_heads, rate, seed)
        return flash_grads(q, k, v, o, lse, do, num_heads, rate, seed)

    @staticmethod
    @once_differentiable
    def backward(ctx, a, bc, c):
        q, k, v, do = ctx.saved_tensors
        num_heads = ctx.args[0]
        o, lse = flash_fwd(q, k, v, *ctx.args)
        cq, ck, cv, cdo = flash_so_vjp(q, k, v, do, a, bc, c, lse, _delta(do, o, num_heads),
                                       *ctx.args)
        return cq, ck, cv, cdo, None, None, None


class FlashAttentionSO(torch.autograd.Function):
    """Packed attention usable under double backward (<- `_flashso` /
    `flash_attention_so_bthd`): the forward is `flash_fwd`, and the backward
    is `FlashGrads`, itself differentiable, so a `create_graph=True` gradient
    stays on the kernels at both orders."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, rate=0.0, seed=0):
        o, _ = flash_fwd(q, k, v, num_heads, rate, seed)
        ctx.save_for_backward(q, k, v)
        ctx.args = (num_heads, rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = FlashGrads.apply(q, k, v, do, *ctx.args)
        return dq, dk, dv, None, None, None
