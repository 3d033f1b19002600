"""Linear sum assignment for the Hungarian matcher (a frozen copy of the port's
module; counterpart of interactron_tpu/ops/hungarian.py::solve_padded).

The JAX package solves on the device with a Jonker-Volgenant loop in `lax`
control flow. In eager PyTorch every step of such a loop would be a
host round trip, so the port copies the detached cost to the host once per
criterion call and solves each frame with scipy's `linear_sum_assignment`,
the upstream reference's own choice (detr_models/matcher.py:73-76). The
padding semantics are those of `solve_padded`: columns are targets, only
valid ones are real, and each valid target gets a distinct query, as in
scipy's rectangular solve on the valid submatrix.
"""

import numpy as np
from scipy.optimize import linear_sum_assignment


def solve_padded(cost, col_valid):
    """cost (n_rows, n_cols) float, col_valid (n_cols,) bool, n_rows >= the
    valid count -> col_to_row (n_cols,) int64: the row assigned to each
    column; 0 at invalid columns, which the caller masks."""
    cost = np.asarray(cost, dtype=np.float64)
    cols = np.flatnonzero(np.asarray(col_valid))
    out = np.zeros(cost.shape[1], dtype=np.int64)
    if cols.size:
        rows, sub = linear_sum_assignment(cost[:, cols])
        out[cols[sub]] = rows
    return out


def batched_solve_padded(cost, col_valid):
    """(F, n_rows, n_cols) costs and (F, n_cols) masks -> (F, n_cols) int64."""
    return np.stack([solve_padded(c, v) for c, v in zip(cost, col_valid)])
