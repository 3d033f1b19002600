"""Positional encodings (a frozen copy of the port's module; counterpart of
interactron_tpu/models/position_encoding.py): the sine encoding of an
unpadded feature map, and the 1-D and 2-D sincos tables of FusionXAttn's
memory positions.

With no padding the reference's cumsums are row/column indices + 1, so
every table is a constant of its sizes, computed once in numpy."""

import numpy as np


def sine_position_embedding(h, w, num_pos_feats=128, temperature=10000.0):
    """Returns (h*w, 2*num_pos_feats) float32, flattened row-major (y, x)."""
    scale = 2 * np.pi
    eps = 1e-6
    y = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :] * np.ones((h, 1), np.float32)
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x[:, :, None] / dim_t
    pos_y = y[:, :, None] / dim_t
    # sin on even dims, cos on odd dims, interleaved
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2)
    return pos.reshape(h * w, -1).astype(np.float32)


def sincos_1d(embed_dim, positions):
    """(M,) positions -> (M, embed_dim) float32: [sin(p*w) | cos(p*w)] with
    w = 1 / 10000^(i / (embed_dim/2)), computed in float64."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = np.asarray(positions, np.float64).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1).astype(np.float32)


def sincos_2d(embed_dim, grid_size):
    """(grid_size^2, embed_dim) float32 2-D sincos grid: the first half
    encodes the column, the second the row (the reference's meshgrid puts w
    first), flattened row-major."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    g = np.arange(grid_size, dtype=np.float32)
    gw, gh = np.meshgrid(g, g)
    emb_h = sincos_1d(embed_dim // 2, gw.reshape(-1))
    emb_w = sincos_1d(embed_dim // 2, gh.reshape(-1))
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)
