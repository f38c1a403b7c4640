"""SparseBatch: the sparse pyramid, pool maps, kernel maps and occupancy
grids of one forward.

Where the batch has static grid dims, levels come from dense-grid pooling
(the grid-dims branch of the JAX package's context): the dense path reads
the occupancy grids; the gather paths read the pool maps' parents and the
kernel maps, which come from a dense voxel->row table per level. With
`precomputed_levels` (the JAX bench's input path, `data/transfer.py`) the
coarse levels come from keys the host computed, and the occupancy from the
max-pool chain; their pool maps carry the overflow flag only. Without
grid dims (`grid_dims=None`), the pyramid comes from sorting and the
kernel maps from a binary search (`core.build_pyramid`, `neighbor_map`):
only the gather paths run on such a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from mask3d_tpu_torch.sparse.core import PoolMap, build_base_level, \
    build_pyramid, build_row_table, cube_offsets, neighbor_map, \
    neighbor_map_table
from mask3d_tpu_torch.sparse.dense_ops import downsample_level_dense, \
    level_from_keys, maxpool2, occupancy


@dataclasses.dataclass
class SparseBatch:
    """levels[0] is stride 1; levels[i] has stride 2**i; pools[i] relates
    levels[i] to levels[i+1]; occ[i] is f32[B, Gx, Gy, Gz, 1] (none without
    grid dims); nbr_idx/nbr_ok[i] is the 3x3x3 kernel map of levels[i]
    (gather path); nbr0_idx/nbr0_ok the input conv's map of levels[0].
    `brick_overflow` is set by the bricked backbone: more occupied level-0
    bricks than its capacity."""

    levels: tuple
    occ: tuple
    pools: tuple
    nbr_idx: tuple = ()
    nbr_ok: tuple = ()
    nbr0_idx: Optional[torch.Tensor] = None  # i32[B, N0, k0^3]
    nbr0_ok: Optional[torch.Tensor] = None
    brick_overflow: Optional[torch.Tensor] = None  # bool[]

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def overflow(self) -> tuple:
        """bool[B] per coarse level: it dropped rows past its capacity."""
        return tuple(p.overflow for p in self.pools)

    def any_overflow(self):
        """bool scalar tensor: any level of any item exceeded its capacity,
        or the bricked backbone had more occupied bricks than its
        capacity."""
        flags = [o.any() for o in self.overflow]
        if self.brick_overflow is not None:
            flags.append(self.brick_overflow)
        return torch.stack(flags).any()


# from mask3d_tpu/sparse/context.py:60 build_sparse_batch (the
# precomputed_levels branch, :86-114, the grid-dims one, :115-131, the
# sorting one, :132-133, and :134-169). The defaults are the dense path's
# (`_sb_kwargs` in infer.py picks them per backbone impl).
def build_sparse_batch(coords, count, dims, level_capacities: Sequence[int],
                       grid_dims: Optional[Sequence] = None,
                       conv1_kernel_size=None,
                       build_block_maps: bool = False,
                       build_pool_parents: bool = False,
                       precomputed_levels: Optional[Sequence] = None
                       ) -> SparseBatch:
    """coords i32[B, N, 3] sorted per item with padding at the end;
    count i32[B]; dims i32[B, 3]; `level_capacities` are the row capacities
    of the coarser levels; `grid_dims` the static per-level grid dims, or
    None: the pyramid by sorting (its PoolMaps always with parents), no
    occupancy grids, kernel maps by binary search. `build_block_maps` adds
    every level's 3x3x3 kernel map, `conv1_kernel_size` (odd, or None) the
    input conv's map of level 0, and `build_pool_parents` the PoolMaps'
    parents and child counts. The options keep the JAX signature; three
    combinations are used: all off (dense), parents only (bricked) and all
    on (the gather impls). `precomputed_levels` [(keys, raw_counts, dims)]
    per coarse level (`transfer.decode_pyramid_u8`) builds the coarse
    levels from those keys; it needs grid dims, and its PoolMaps have no
    parents, so it refuses `build_pool_parents` (the bricked and gather
    impls) rather than build a batch their backbones cannot read."""
    base = build_base_level(coords, count, dims)
    if precomputed_levels is not None:
        if grid_dims is None or build_pool_parents:
            raise ValueError(
                "precomputed_levels needs grid dims and builds no pool "
                "parents: it serves the dense backbone only (the bricked "
                "and gather impls read parents)")
        if len(precomputed_levels) != len(level_capacities):
            raise ValueError(f"{len(precomputed_levels)} precomputed levels"
                             f" for {len(level_capacities)} capacities")
        levels, pools = [base], []
        occ = [occupancy(base, grid_dims[0])]
        for li, (cap, (keys_l, raw_l, dims_l)) in enumerate(
                zip(level_capacities, precomputed_levels)):
            levels.append(level_from_keys(keys_l, raw_l, dims_l,
                                          stride=2 ** (li + 1),
                                          capacity=cap))
            occ.append(maxpool2(occ[-1]))
            pools.append(PoolMap(parent=None, kidx=None, nchild=None,
                                 overflow=raw_l > cap))
    elif grid_dims is None:
        levels, pools = build_pyramid(base, level_capacities)
        occ = []
    else:
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
        if grid_dims is None:
            return neighbor_map(levels[li], offsets)
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


def slab_row_ranges(level, x0: int, x1: int):
    """(lo, hi) i64[B, 1]: the rows of each item whose cell lies in the
    x-slab [x0, x1). Rows are sorted by their x-major key with padding at
    the end, so they are one contiguous range, found by `searchsorted` on
    the rows' x (padding reads as past every slab)."""
    x = torch.where(level.valid, level.coords[..., 0],
                    torch.iinfo(torch.int32).max).contiguous()
    b = x.shape[0]
    bounds = torch.tensor([[x0, x1]], dtype=x.dtype,
                          device=x.device).expand(b, 2).contiguous()
    r = torch.searchsorted(x, bounds)
    return r[:, :1], r[:, 1:]


def slab_rows(level, x0: int, x1: int):
    """bool[B, N]: the valid rows of each item inside the x-slab [x0, x1)
    (`slab_row_ranges`)."""
    lo, hi = slab_row_ranges(level, x0, x1)
    rows = torch.arange(level.capacity, device=lo.device)[None]
    return (rows >= lo) & (rows < hi) & level.valid
