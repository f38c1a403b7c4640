"""SparseBatch: the sparse pyramid, pool maps, kernel maps and occupancy
grids of one forward.

Levels come from dense-grid pooling (the grid-dims branch of the JAX
package's context). The dense path reads the occupancy grids; the gather
path reads the pool maps' parents and the kernel maps, which come from a
dense voxel->row table per level.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from mask3d_tpu_torch.sparse.core import build_base_level, build_row_table, \
    cube_offsets, neighbor_map_table
from mask3d_tpu_torch.sparse.dense_ops import downsample_level_dense, \
    occupancy


@dataclasses.dataclass
class SparseBatch:
    """levels[0] is stride 1; levels[i] has stride 2**i; pools[i] relates
    levels[i] to levels[i+1]; occ[i] is f32[B, Gx, Gy, Gz, 1];
    nbr_idx/nbr_ok[i] is the 3x3x3 kernel map of levels[i] (gather path);
    nbr0_idx/nbr0_ok the input conv's map of levels[0]."""

    levels: tuple
    occ: tuple
    pools: tuple
    nbr_idx: tuple = ()
    nbr_ok: tuple = ()
    nbr0_idx: Optional[torch.Tensor] = None  # i32[B, N0, k0^3]
    nbr0_ok: Optional[torch.Tensor] = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def overflow(self) -> tuple:
        """bool[B] per coarse level: it dropped rows past its capacity."""
        return tuple(p.overflow for p in self.pools)

    def any_overflow(self):
        """bool scalar tensor: any level of any item exceeded capacity."""
        return torch.stack([o.any() for o in self.overflow]).any()


# from mask3d_tpu/sparse/context.py:60 build_sparse_batch (the grid-dims
# branch, :115-131 and :134-169; no precomputed_levels). The defaults are
# the dense path's (`_sb_kwargs` in infer.py picks them per backbone impl).
def build_sparse_batch(coords, count, dims, level_capacities: Sequence[int],
                       grid_dims: Sequence, conv1_kernel_size=None,
                       build_block_maps: bool = False,
                       build_pool_parents: bool = False) -> SparseBatch:
    """coords i32[B, N, 3] sorted per item with padding at the end;
    count i32[B]; dims i32[B, 3]; `level_capacities` are the row capacities
    of the coarser levels; `grid_dims` the static per-level grid dims.
    `build_block_maps` adds every level's 3x3x3 kernel map,
    `conv1_kernel_size` (odd, or None) the input conv's map of level 0, and
    `build_pool_parents` the PoolMaps' parents and child counts. The
    options keep the JAX signature; only two combinations are used: all
    off (dense) and all on (the gather impls)."""
    base = build_base_level(coords, count, dims)
    levels, pools = [base], []
    occ = [occupancy(base, grid_dims[0])]
    for li, cap in enumerate(level_capacities):
        coarse, pool, occ_c = downsample_level_dense(
            levels[-1], grid_dims[li], cap, occ_f=occ[-1],
            with_parent=build_pool_parents)
        levels.append(coarse)
        pools.append(pool)
        occ.append(occ_c)

    tables = {}

    def maps_for(li, offsets):
        if li not in tables:
            gd = grid_dims[li]
            tables[li] = build_row_table(levels[li], gd[0] * gd[1] * gd[2])
        return neighbor_map_table(levels[li], tables[li], offsets)

    nbr_idx, nbr_ok = [], []
    if build_block_maps:
        off3 = cube_offsets(1)
        for li in range(len(levels)):
            i, o = maps_for(li, off3)
            nbr_idx.append(i)
            nbr_ok.append(o)
    nbr0_idx = nbr0_ok = None
    if conv1_kernel_size is not None:
        if conv1_kernel_size % 2 != 1:
            raise ValueError(f"conv1_kernel_size {conv1_kernel_size} is even")
        if conv1_kernel_size == 3 and build_block_maps:
            nbr0_idx, nbr0_ok = nbr_idx[0], nbr_ok[0]
        else:
            nbr0_idx, nbr0_ok = maps_for(0, cube_offsets(
                conv1_kernel_size // 2))
    return SparseBatch(levels=tuple(levels), occ=tuple(occ),
                       pools=tuple(pools), nbr_idx=tuple(nbr_idx),
                       nbr_ok=tuple(nbr_ok), nbr0_idx=nbr0_idx,
                       nbr0_ok=nbr0_ok)
