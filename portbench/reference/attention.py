"""Dense multi-head attention and the dropout hash of the reference model
(a frozen copy of the port's ops/attention.py dense path and of the plain
mask of ops/flash_attention.py).

Every attention is dense, with fp32 logits and softmax, whatever its size:
the port's fused kernels compute the same function. Dropout keeps an
element where the 32-bit hash of (seed, b*H + h, row, col) reaches the
rate's integer threshold, the hash that the port's kernels and plain
versions share, so a seed gives the port's masks bit for bit.
"""

import math

import torch

_M32 = 0xFFFFFFFF
_SEED_SALT = 0x6A09E667
_MIX_BH = 0x9E3779B9
_MIX_ROW = 0x85EBCA77
_MIX_COL = 0xC2B2AE3D
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35


def draw_seed(gen):
    """An int32 dropout seed from the caller's generator."""
    return int(torch.randint(0, 2**31 - 1, (), generator=gen))


def keep_threshold(rate):
    """An element is kept iff its 32-bit hash >= this."""
    return min(int(rate * 4294967296.0), 4294967295)


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _fmix(h):
    h = h ^ (h >> 16)
    h = _mul32(h, _FMIX1)
    h = h ^ (h >> 13)
    h = _mul32(h, _FMIX2)
    return h ^ (h >> 16)


def _hash_bits(seed, bh, rows, cols):
    h0 = _fmix((((seed & _M32) ^ _SEED_SALT) + _mul32(bh, _MIX_BH)) & _M32)
    h1 = _fmix(h0[:, None] ^ _mul32(rows, _MIX_ROW)[None, :])
    return _fmix(h1[:, :, None] ^ _mul32(cols, _MIX_COL)[None, None, :])


def dropout_mask(seed, rate, shape, offsets=(0, 0, 0), device="cpu"):
    """uint8 keep mask of the region `shape` = (n_bh, n_rows, n_cols) at
    `offsets`, built a block of bh rows at a time."""
    idx = [torch.arange(o, o + n, device=device, dtype=torch.int64)
           for o, n in zip(offsets, shape)]
    out = torch.empty(shape, dtype=torch.uint8, device=device)
    step = max(1, (1 << 24) // max(1, shape[1] * shape[2]))
    for i in range(0, shape[0], step):
        out[i:i + step] = (_hash_bits(seed, idx[0][i:i + step], idx[1], idx[2])
                           >= keep_threshold(rate))
    return out


def dropout_apply(x, seed, rate, region, offsets=(0, 0, 0)):
    """x * keep / (1 - rate), x viewed as `region` at `offsets`."""
    keep = dropout_mask(seed, rate, tuple(region), tuple(offsets), x.device)
    return x * keep.view(x.shape) * (1.0 / (1.0 - rate))


def packed_attention(q, k, v, num_heads, dropout_rate=0.0, gen=None):
    """q (B, T, H*D), k/v (B, S, H*D) -> (B, T, H*D) in q's dtype, with
    dropout of the probabilities at `dropout_rate` when `gen` is given."""
    b, t, dim = q.shape
    s = k.shape[1]
    h = num_heads
    hd = dim // h
    rate = float(dropout_rate) if gen is not None else 0.0
    seed = draw_seed(gen) if rate > 0.0 else 0
    qh = q.reshape(b, t, h, hd)
    kh = k.reshape(b, s, h, hd)
    vh = v.reshape(b, s, h, hd)
    logits = torch.einsum("bthd,bshd->bhts", qh.float(), kh.float()) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits, dim=-1)
    if rate > 0.0:
        probs = dropout_apply(probs, seed, rate, (b * h, t, s))
    return torch.einsum("bhts,bshd->bthd", probs.to(q.dtype), vh).reshape(b, t, dim)
