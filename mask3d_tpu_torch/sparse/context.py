"""SparseBatch: the sparse pyramid and occupancy grids of one forward.

The port builds the dense-path context only: levels by dense-grid pooling,
and an occupancy grid per level for the backbone and the pooled pyramid.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from mask3d_tpu_torch.sparse.core import build_base_level
from mask3d_tpu_torch.sparse.dense_ops import downsample_level_dense, \
    occupancy


@dataclasses.dataclass
class SparseBatch:
    """levels[0] is stride 1; levels[i] has stride 2**i; occ[i] is
    f32[B, Gx, Gy, Gz, 1]; overflow[i] is bool[B], true where levels[i+1]
    dropped rows past its capacity."""

    levels: tuple
    occ: tuple
    overflow: tuple

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def any_overflow(self):
        """bool scalar tensor: any level of any item exceeded capacity."""
        return torch.stack([o.any() for o in self.overflow]).any()


# from mask3d_tpu/sparse/context.py:60 build_sparse_batch (dense branch,
# :115-131, no precomputed_levels)
def build_sparse_batch(coords, count, dims, level_capacities: Sequence[int],
                       grid_dims: Sequence) -> SparseBatch:
    """coords i32[B, N, 3] sorted per item with padding at the end;
    count i32[B]; dims i32[B, 3]; `level_capacities` are the row capacities
    of the coarser levels; `grid_dims` the static per-level grid dims."""
    base = build_base_level(coords, count, dims)
    levels, overflow = [base], []
    occ = [occupancy(base, grid_dims[0])]
    for li, cap in enumerate(level_capacities):
        coarse, ovf, occ_c = downsample_level_dense(
            levels[-1], grid_dims[li], cap, occ_f=occ[-1])
        levels.append(coarse)
        overflow.append(ovf)
        occ.append(occ_c)
    return SparseBatch(levels=tuple(levels), occ=tuple(occ),
                       overflow=tuple(overflow))
