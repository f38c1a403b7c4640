"""Linear sum assignment (Hungarian matching) on the host.

The JAX package solves every (level x item) problem of a batch on the
device with a jittable Jonker-Volgenant loop (its `method="device"`); the
port copies the batch's costs to the host in one transfer and solves each
problem with scipy, the JAX package's `method="host"` oracle. Both give the
same optimum; where it is not unique they may pick different, equally
optimal assignments.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment as _scipy_lsa


# from mask3d_tpu/ops/lsap.py:117 linear_sum_assignment
def linear_sum_assignment(cost: np.ndarray) -> np.ndarray:
    """Batched exact LSAP.

    cost: f32[..., R, C] (rectangular ok; padded to square with a per-problem
    constant). Returns col4row i32[..., R]: the column assigned to each row;
    rows matched to padding columns get their padded column index >= C
    (the caller filters with `col4row < C`).
    """
    cost = np.asarray(cost, np.float32)
    r, c = cost.shape[-2], cost.shape[-1]
    n = max(r, c)
    # The padding constant sits just above the problem's largest cost:
    # every assignment of leftover rows or columns to padding then has the
    # same total, so the optimum on the real submatrix is kept.
    pad_val = cost.max(axis=(-2, -1), keepdims=True) + np.float32(1.0)
    sq = np.broadcast_to(pad_val, cost.shape[:-2] + (n, n)).copy()
    sq[..., :r, :c] = cost
    flat = sq.reshape((-1, n, n))
    out = np.stack([_scipy_lsa(x)[1] for x in flat]).astype(np.int32)
    return out.reshape(sq.shape[:-1])[..., :r]
