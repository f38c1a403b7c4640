"""Sparse-voxel levels: per-item padded rows sorted by a linearized key.

Layout per item: rows sorted ascending by `key = (x*Dy + y)*Dz + z`;
padding rows carry key INT32_MAX and coords 0; `dims` is the per-item grid
extent at the level. Every tensor has a leading batch axis B and a fixed
per-item capacity N.

Kernel maps (the gather path) come from a dense voxel->row table per level
(`build_row_table` + `neighbor_map_table`) where the batch has static grid
dims, else from a binary search over the sorted keys (`neighbor_map`), and
the pyramid then comes from sorting (`downsample_level`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

INT32_MAX = 2**31 - 1


# from mask3d_tpu/sparse/core.py:46 cube_offsets
def cube_offsets(radius: int) -> torch.Tensor:
    """i32[(2r+1)^3, 3]: the offsets of a cubic kernel, x-major / z-fastest.
    The weight-index order of every gather-path conv (`[K, Cin, Cout]`)."""
    r = torch.arange(-radius, radius + 1, dtype=torch.int32)
    x, y, z = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)


# from mask3d_tpu/sparse/core.py:59 pack_keys
def pack_keys(coords, dims):
    """Linearize (x, y, z) into a single int32 sort key."""
    return (coords[..., 0] * dims[..., 1] + coords[..., 1]) * dims[
        ..., 2
    ] + coords[..., 2]


# from mask3d_tpu/sparse/core.py:66 unpack_keys
def unpack_keys(keys, dims):
    """Inverse of `pack_keys`: i32[B, N] + dims i32[B, 3] -> i32[B, N, 3].
    Padding rows decode to garbage; consumers mask by `count`."""
    dy = dims[..., 1][..., None]
    dz = dims[..., 2][..., None]
    z = keys % dz
    r = keys // dz
    y = r % dy
    x = r // dy
    return torch.stack([x, y, z], dim=-1)


# from mask3d_tpu/sparse/core.py:83 SparseLevel
@dataclasses.dataclass
class SparseLevel:
    """One resolution level of a batched sparse voxel set."""

    key: torch.Tensor  # i32[B, N] sorted ascending per item, pad INT32_MAX
    coords: torch.Tensor  # i32[B, N, 3] in units of this level's stride
    valid: torch.Tensor  # bool[B, N]
    count: torch.Tensor  # i32[B] number of real rows per item
    dims: torch.Tensor  # i32[B, 3] per-item grid extent at this level
    stride: int

    @property
    def batch_size(self) -> int:
        return self.key.shape[0]

    @property
    def capacity(self) -> int:
        return self.key.shape[-1]


# from mask3d_tpu/sparse/core.py:105 PoolMap
@dataclasses.dataclass
class PoolMap:
    """Fine level -> its stride-2 coarse level. `parent` is the coarse row of
    each fine row (the coarse capacity for padding and overflowed rows, which
    segment sums drop), `kidx` its child position `(x&1)*4 + (y&1)*2 +
    (z&1)`, `nchild` the occupied children of each coarse row and
    `child_rows` the fine row at each coarse row's child position
    (`child_row_table`; the segment sums of `sparse/ops.py` read it). The
    dense path builds only `overflow` and leaves the rest None."""

    parent: Optional[torch.Tensor]  # i32[B, N_fine]
    kidx: Optional[torch.Tensor]  # i32[B, N_fine] in [0, 8)
    nchild: Optional[torch.Tensor]  # i32[B, N_coarse]
    overflow: torch.Tensor  # bool[B] coarse capacity exceeded
    child_rows: Optional[torch.Tensor] = None  # i64[B, N_coarse, 8]


def child_row_table(parent, kidx, coarse_capacity: int):
    """i64[B, coarse_capacity, 8]: the fine row at each coarse row's child
    position, N_fine where there is none. A fine row's (parent, child
    position) is its own voxel, so a slot takes at most one row: an integer
    scatter-add writes them, exact in any order; the rows whose parent is
    the coarse capacity (padding, overflow) land past the table."""
    b, n_fine = parent.shape
    dev = parent.device
    slot = parent.long() * 8 + kidx.long()
    tab = torch.zeros((b, (coarse_capacity + 1) * 8), dtype=torch.long,
                      device=dev)
    tab.scatter_add_(1, slot, torch.arange(1, n_fine + 1, device=dev)
                     .expand(b, n_fine))
    tab = tab[:, :coarse_capacity * 8].view(b, coarse_capacity, 8)
    return torch.where(tab > 0, tab - 1, n_fine)


# from mask3d_tpu/sparse/core.py:124 build_base_level
def build_base_level(coords, count, dims) -> SparseLevel:
    """Wrap collated, already-sorted stride-1 voxels into a SparseLevel."""
    coords = coords.to(torch.int32)
    count = count.to(torch.int32)
    dims = dims.to(torch.int32)
    n = coords.shape[1]
    rows = torch.arange(n, dtype=torch.int32, device=coords.device)[None, :]
    valid = rows < count[:, None]
    coords = torch.where(valid[..., None], coords, 0)
    key = torch.where(valid, pack_keys(coords, dims[:, None, :]), INT32_MAX)
    return SparseLevel(key=key.to(torch.int32), coords=coords, valid=valid,
                       count=count, dims=dims, stride=1)


# from mask3d_tpu/sparse/core.py:144 _downsample_item (batched) and :206
# downsample_level
def downsample_level(level: SparseLevel, capacity: int):
    """The stride-2 coarse level and the fine -> coarse PoolMap by sorting:
    the coarse rows are the unique `coords >> 1` of each item in key order.
    Rows past `capacity` are dropped and flagged; their fine rows' parent
    is `capacity`, as are the padding rows'."""
    b, n = level.key.shape
    dev = level.key.device
    dims_c = ((level.dims - 1) >> 1) + 1
    cc = level.coords >> 1
    child_key = torch.where(level.valid, pack_keys(cc, dims_c[:, None, :]),
                            INT32_MAX).to(torch.int32)
    order = torch.argsort(child_key, dim=1, stable=True)
    sorted_key = torch.gather(child_key, 1, order)
    is_real = sorted_key != INT32_MAX
    first = torch.ones_like(is_real)
    first[:, 1:] = sorted_key[:, 1:] != sorted_key[:, :-1]
    new = is_real & first
    pos = torch.cumsum(new.to(torch.int32), dim=1, dtype=torch.int32) - 1
    count_c = new.sum(dim=1, dtype=torch.int32)
    # every row but the first of each kept coarse row writes the drop slot
    write = torch.where(new & (pos < capacity), pos, capacity).long()
    key_c = torch.full((b, capacity + 1), INT32_MAX, dtype=torch.int32,
                       device=dev)
    key_c.scatter_(1, write, sorted_key)
    coords_c = torch.zeros((b, capacity + 1, 3), dtype=torch.int32,
                           device=dev)
    sorted_cc = torch.gather(cc, 1, order[..., None].expand(-1, -1, 3))
    coords_c.scatter_(1, write[..., None].expand(-1, -1, 3),
                      sorted_cc.to(torch.int32))
    count = torch.clamp(count_c, max=capacity)
    valid_c = torch.arange(capacity, device=dev)[None] < count[:, None]
    coarse = SparseLevel(key=key_c[:, :capacity].contiguous(),
                         coords=coords_c[:, :capacity].contiguous(),
                         valid=valid_c,
                         count=count, dims=dims_c, stride=level.stride * 2)
    parent_sorted = torch.where(is_real & (pos < capacity), pos, capacity)
    parent = torch.empty((b, n), dtype=torch.int32, device=dev)
    parent.scatter_(1, order, parent_sorted)
    fc = level.coords
    kidx = ((fc[..., 0] & 1) * 4 + (fc[..., 1] & 1) * 2
            + (fc[..., 2] & 1)).to(torch.int32)
    nchild = torch.zeros((b, capacity + 1), dtype=torch.int32, device=dev)
    nchild.scatter_add_(1, parent.long(), level.valid.to(torch.int32))
    pool = PoolMap(parent=parent, kidx=kidx, nchild=nchild[:, :capacity],
                   overflow=count_c > capacity,
                   child_rows=child_row_table(parent, kidx, capacity))
    return coarse, pool


# from mask3d_tpu/sparse/core.py:229 build_pyramid
def build_pyramid(base: SparseLevel, capacities):
    """(levels, pools): `capacities[i]` rows at level i + 1; `pools[i]`
    relates levels[i] to levels[i + 1]."""
    levels, pools = [base], []
    for cap in capacities:
        coarse, pool = downsample_level(levels[-1], cap)
        levels.append(coarse)
        pools.append(pool)
    return levels, pools


# from mask3d_tpu/sparse/core.py:245 _neighbor_map_item (batched) and :264
# neighbor_map
def neighbor_map(level: SparseLevel, offsets, chunk: int = 32):
    """Kernel map by binary search over each item's sorted keys, for levels
    without a static grid: (idx i32[B, N, K], ok bool[B, N, K]). Where ok
    is false idx is the search position, clamped into the level (the JAX
    package's values, which no consumer reads)."""
    b, n = level.key.shape
    dev = level.key.device
    dims = level.dims[:, None, None, :]
    offsets = offsets.to(device=dev, dtype=torch.int32)
    idx_parts, ok_parts = [], []
    for s in range(0, offsets.shape[0], chunk):
        offs = offsets[s:s + chunk]
        ncoords = level.coords[:, :, None, :] + offs[None, None, :, :]
        in_bounds = (((ncoords >= 0) & (ncoords < dims)).all(dim=-1)
                     & level.valid[:, :, None])
        nkey = torch.where(in_bounds, pack_keys(ncoords, dims),
                           INT32_MAX).to(torch.int32)
        idx = torch.searchsorted(level.key, nkey.reshape(b, -1),
                                 out_int32=True).clamp(max=n - 1)
        got = torch.gather(level.key, 1, idx.long())
        idx_parts.append(idx.reshape(nkey.shape))
        ok_parts.append(in_bounds & (got.reshape(nkey.shape) == nkey))
    return torch.cat(idx_parts, dim=2), torch.cat(ok_parts, dim=2)


# from mask3d_tpu/sparse/core.py:283 build_row_table
def build_row_table(level: SparseLevel, cells: int):
    """Dense voxel->row lookup: i32[B, cells], -1 for empty cells. `cells`
    is >= Dx*Dy*Dz of every item at this level (the static grid)."""
    b, n = level.key.shape
    dev = level.key.device
    rows = torch.arange(n, dtype=torch.int32, device=dev)[None].expand(b, n)
    key = level.key.long()
    write_key = torch.where(level.valid & (key < cells), key, cells)
    b_idx = torch.arange(b, device=dev)[:, None].expand(b, n)
    table = torch.full((b, cells + 1), -1, dtype=torch.int32, device=dev)
    table[b_idx, write_key] = rows
    return table[:, :cells]


# from mask3d_tpu/sparse/core.py:304 neighbor_map_table
def neighbor_map_table(level: SparseLevel, table, offsets, chunk: int = 32):
    """Kernel map of a same-stride conv: per row and offset, the row at
    coords + offset. Returns (idx i32[B, N, K], ok bool[B, N, K]); idx is 0
    where ok is false. `chunk` offsets at a time bound the transients."""
    b, n = level.key.shape
    dev = level.key.device
    dims = level.dims[:, None, None, :]  # [B, 1, 1, 3]
    offsets = offsets.to(device=dev, dtype=torch.int32)
    idx_parts, ok_parts = [], []
    for s in range(0, offsets.shape[0], chunk):
        offs = offsets[s:s + chunk]
        ncoords = level.coords[:, :, None, :] + offs[None, None, :, :]
        in_bounds = (((ncoords >= 0) & (ncoords < dims)).all(dim=-1)
                     & level.valid[:, :, None])
        nkey = torch.where(in_bounds, pack_keys(ncoords, dims), 0)
        got = torch.gather(table, 1, nkey.reshape(b, -1).long()).reshape(
            nkey.shape)
        ok = in_bounds & (got >= 0)
        idx_parts.append(torch.where(ok, got, 0).to(torch.int32))
        ok_parts.append(ok)
    return torch.cat(idx_parts, dim=2), torch.cat(ok_parts, dim=2)
