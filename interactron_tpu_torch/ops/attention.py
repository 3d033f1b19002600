"""Multi-head attention on the packed (B, T, H*D) head layout (counterpart
of interactron_tpu/ops/attention.py::packed_attention and flash_disabled).

Large problems go to the fused kernels (ops/flash_attention.py); the rest
take a dense path with fp32 logits and an fp32 softmax. The gates are the
JAX package's, so the same attentions reach a kernel: the FusionGPT (S=2060,
hd=64) and the DETR encoder (S=361, hd=32); the DETR decoder's 50 queries
stay dense. They were tuned on a TPU and are kept as they are until H100
measurements say otherwise.

Inside `flash_disabled()` (code that is differentiated twice: the meta
inner loss) attentions past the second-order gates take `FlashAttentionSO`,
whose backward is itself differentiable and runs the second-order kernel;
outside it they take the first-order `FlashAttention`.

Dropout is on when the caller passes a generator: one int32 seed is drawn
from it per attention call, and the keep bits are the kernels' hash of
(seed, b*H + h, row, col), on the fused and the dense path alike.
"""

import contextlib
import math

import torch

from interactron_tpu_torch.ops.flash_attention import (
    FlashAttention,
    FlashAttentionSO,
    draw_seed,
    dropout_mask,
)

FLASH_MIN_HD = 32
FLASH_MIN_S = 256
FLASH_MIN_T = 128
# the twice-differentiated context's own gates (<- _FLASH_SO_MIN_*)
FLASH_SO_MIN_HD = 32
FLASH_SO_MIN_S = 256
FLASH_SO_MIN_T = 128

_flash_suppressed = False


@contextlib.contextmanager
def flash_disabled():
    """Code inside is differentiated twice: attentions take the second-order
    route (FlashAttentionSO past the FLASH_SO_* gates, dense otherwise)."""
    global _flash_suppressed
    prev = _flash_suppressed
    _flash_suppressed = True
    try:
        yield
    finally:
        _flash_suppressed = prev


def packed_attention(q, k, v, num_heads, dropout_rate=0.0, gen=None):
    """q (B, T, H*D), k/v (B, S, H*D) -> (B, T, H*D) in q's dtype, with
    attention-probability dropout at `dropout_rate` when `gen` is given."""
    b, t, dim = q.shape
    s = k.shape[1]
    h = num_heads
    hd = dim // h
    rate = float(dropout_rate) if gen is not None else 0.0
    seed = draw_seed(gen) if rate > 0.0 else 0
    if not _flash_suppressed and hd >= FLASH_MIN_HD and s >= FLASH_MIN_S and t >= FLASH_MIN_T:
        return FlashAttention.apply(q, k, v, h, rate, seed)
    if _flash_suppressed and hd >= FLASH_SO_MIN_HD and s >= FLASH_SO_MIN_S and t >= FLASH_SO_MIN_T:
        return FlashAttentionSO.apply(q, k, v, h, rate, seed)
    in_dtype = q.dtype
    qh = q.reshape(b, t, h, hd)
    kh = k.reshape(b, s, h, hd)
    vh = v.reshape(b, s, h, hd)
    logits = torch.einsum("bthd,bshd->bhts", qh.float(), kh.float()) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits, dim=-1)
    if rate > 0.0:
        keep = dropout_mask(seed, rate, (b * h, t, s), q.device).view(b, h, t, s)
        probs = probs * keep * (1.0 / (1.0 - rate))
    out = torch.einsum("bhts,bshd->bthd", probs.to(in_dtype), vh)
    return out.reshape(b, t, dim)
