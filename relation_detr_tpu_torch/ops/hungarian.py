"""Min-cost assignment of ground-truth rows to query columns, on the host.

Counterpart of ``relation_detr_tpu/ops/hungarian.py::hungarian_assignment``.
The JAX package solves on the device (a Jonker-Volgenant solver under jit,
padded rows skipped); the port does what the reference matcher does and
calls ``scipy.optimize.linear_sum_assignment`` on the host, one solve per
image and output set. Only the valid rows are solved; the JAX solver's
padded rows carry no cost, so both reach the same optimal cost.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def hungarian_assignment(cost: np.ndarray, row_mask: np.ndarray) -> np.ndarray:
    """cost (R, M) with R <= M, row_mask (R,) bool -> (R,) int64: the column
    assigned to each valid row, -1 for the other rows."""
    rows = np.flatnonzero(row_mask)
    match = np.full(cost.shape[0], -1, np.int64)
    if rows.size:
        sub = cost[rows]
        if not np.isfinite(sub).all():
            # a non-finite forward: scipy refuses it; any assignment does,
            # since the train step skips the non-finite loss
            sub = np.nan_to_num(sub, nan=1e30, posinf=1e30, neginf=-1e30)
        row_ind, col_ind = linear_sum_assignment(sub)
        match[rows[row_ind]] = col_ind
    return match
