"""Multi-head attention on the packed (B, T, H*D) head layout (counterpart
of interactron_tpu/ops/attention.py::packed_attention and flash_disabled).

Large problems go to the fused kernels (ops/flash_attention.py); the rest
take a dense path with fp32 logits and an fp32 softmax. The gates are the
JAX package's, so the same attentions reach a kernel: the FusionGPT (S=2060,
hd=64), FusionXAttn's cross-attention (T=255, S=1805, hd=64), the ViT-B/16
encoder (S=361, hd=64, 12 heads) and the DETR encoder (S=361, hd=32); the
DETR decoder's 50 queries and FusionXAttn's 255-token self-attention stay
dense. They were tuned on a TPU and are kept as they are until H100
measurements say otherwise.

Inside `flash_disabled()` (code that is differentiated twice: the meta
inner loss) attentions past the second-order gates take `FlashAttentionSO`,
whose backward is itself differentiable and runs the second-order kernel;
outside it they take the first-order `FlashAttention`. While a CUDA graph
of a pass is being captured (utils/cuda_graphs.py), a call that reaches
the first-order kernel ends the graph's current piece instead, so the
kernel is launched between the pieces at each replay.

Two per-call switches, which tasks/base.py sets on every attention module
from the config: `flash=False` (MODEL.FLASH_ATTENTION: False) sends every
attention to the dense path, and `chunked=True` (MODEL.CHUNKED_ATTENTION)
runs a dense attention of at least CHUNK_MIN_ELEMENTS logits in blocks of
CHUNK_BLOCK queries, each recomputed in the backward, so the (T, S)
probabilities never exist whole, at either order of differentiation.

Dropout is on when the caller passes a generator: one int32 seed is drawn
from it per attention call, and the keep bits are the kernels' hash of
(seed, b*H + h, row, col), on the fused, the dense and the chunked path
alike. The dense path applies them through `dropout_apply`, which under
MODEL.REMAT_DROPOUT saves no mask and regenerates it in the backward.
"""

import contextlib
import math
import os

import torch
from torch.utils.checkpoint import checkpoint

from interactron_tpu_torch.ops.flash_attention import (
    FlashAttention,
    FlashAttentionSO,
    draw_seed,
    dropout_apply,
)
from interactron_tpu_torch.utils import cuda_graphs

# the gates, overridden by the environment variables of the same names
# with the JAX package's defaults (<- _FLASH_MIN_*, read at import)
FLASH_MIN_HD = int(os.environ.get("FLASH_MIN_HD", 32))
FLASH_MIN_S = int(os.environ.get("FLASH_MIN_S", 256))
FLASH_MIN_T = int(os.environ.get("FLASH_MIN_T", 128))
# the twice-differentiated context's own gates (<- _FLASH_SO_MIN_*)
FLASH_SO_MIN_HD = int(os.environ.get("FLASH_SO_MIN_HD", 32))
FLASH_SO_MIN_S = int(os.environ.get("FLASH_SO_MIN_S", 256))
FLASH_SO_MIN_T = int(os.environ.get("FLASH_SO_MIN_T", 128))
# the chunked path's gate on b*H*T*S and its query block (<- _chunked_attention_bthd)
CHUNK_MIN_ELEMENTS = 4 * 1024 * 1024
CHUNK_BLOCK = 256

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


def packed_attention(q, k, v, num_heads, dropout_rate=0.0, gen=None, flash=True,
                     chunked=False):
    """q (B, T, H*D), k/v (B, S, H*D) -> (B, T, H*D) in q's dtype, with
    attention-probability dropout at `dropout_rate` when `gen` is given.
    `flash` lets the problem take a kernel past the gates; `chunked` runs
    a large dense one in query blocks."""
    b, t, dim = q.shape
    s = k.shape[1]
    h = num_heads
    hd = dim // h
    rate = float(dropout_rate) if gen is not None else 0.0
    seed = draw_seed(gen) if rate > 0.0 else 0
    if flash and not _flash_suppressed and (
            hd >= FLASH_MIN_HD and s >= FLASH_MIN_S and t >= FLASH_MIN_T):
        graph = cuda_graphs.capturing()
        if graph is not None:
            return graph.attention(q, k, v, h, rate)
        return FlashAttention.apply(q, k, v, h, rate, seed)
    if flash and _flash_suppressed and (
            hd >= FLASH_SO_MIN_HD and s >= FLASH_SO_MIN_S and t >= FLASH_SO_MIN_T):
        return FlashAttentionSO.apply(q, k, v, h, rate, seed)
    qh = q.reshape(b, t, h, hd)
    kh = k.reshape(b, s, h, hd)
    vh = v.reshape(b, s, h, hd)
    if chunked and b * h * t * s >= CHUNK_MIN_ELEMENTS:
        out = torch.cat([checkpoint(_dense_rows, qh[:, r:r + CHUNK_BLOCK], kh, vh, rate, seed, r,
                                    use_reentrant=False)
                         for r in range(0, t, CHUNK_BLOCK)], dim=1)
    else:
        out = _dense_rows(qh, kh, vh, rate, seed)
    return out.reshape(b, t, dim)


def _dense_rows(qh, kh, vh, rate, seed, row0=0):
    """Dense attention of the query rows row0 .. row0 + len(qh) (bthd
    layout), fp32 logits and softmax; the keep bits are those of the rows'
    place in the whole problem."""
    b, t, h, hd = qh.shape
    s = kh.shape[1]
    logits = torch.einsum("bthd,bshd->bhts", qh.float(), kh.float()) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits, dim=-1)
    if rate > 0.0:
        probs = dropout_apply(probs, seed, rate, (b * h, t, s), (0, row0, 0))
    return torch.einsum("bhts,bshd->bthd", probs.to(qh.dtype), vh)
