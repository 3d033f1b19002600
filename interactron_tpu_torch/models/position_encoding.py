"""Sine positional encoding of an unpadded feature map (own copy of
interactron_tpu/models/position_encoding.py::sine_position_embedding).

With no padding the reference's cumsums are row/column indices + 1, so the
table is a constant of the grid size, computed once in numpy."""

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
