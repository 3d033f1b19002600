"""Multi-head attention on the packed (B, T, H*D) head layout (counterpart
of interactron_tpu/ops/attention.py::packed_attention).

Large problems go to the fused kernels (ops/flash_attention.py); the rest
take a dense path with fp32 logits and an fp32 softmax. The gates are the
JAX package's first-order ones, so the same attentions reach a kernel: the
FusionGPT (S=2060, hd=64) and the DETR encoder (S=361, hd=32); the DETR
decoder's 50 queries stay dense. They were tuned on a TPU and are kept as
they are until H100 measurements say otherwise.
"""

import math

import torch

from interactron_tpu_torch.ops.flash_attention import FlashAttention

FLASH_MIN_HD = 32
FLASH_MIN_S = 256
FLASH_MIN_T = 128


def packed_attention(q, k, v, num_heads, dropout_rate=0.0):
    """q (B, T, H*D), k/v (B, S, H*D) -> (B, T, H*D) in q's dtype."""
    b, t, dim = q.shape
    s = k.shape[1]
    h = num_heads
    hd = dim // h
    if hd >= FLASH_MIN_HD and s >= FLASH_MIN_S and t >= FLASH_MIN_T:
        return FlashAttention.apply(q, k, v, h, dropout_rate)
    if dropout_rate != 0.0:
        raise NotImplementedError("attention dropout comes with the train slice")
    in_dtype = q.dtype
    qh = q.reshape(b, t, h, hd)
    kh = k.reshape(b, s, h, hd)
    vh = v.reshape(b, s, h, hd)
    logits = torch.einsum("bthd,bshd->bhts", qh.float(), kh.float()) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits, dim=-1).to(in_dtype)
    out = torch.einsum("bhts,bshd->bthd", probs, vh)
    return out.reshape(b, t, dim)
