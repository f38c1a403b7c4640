"""Sparse-voxel levels: per-item padded rows sorted by a linearized key.

Layout per item: rows sorted ascending by `key = (x*Dy + y)*Dz + z`;
padding rows carry key INT32_MAX and coords 0; `dims` is the per-item grid
extent at the level. Every tensor has a leading batch axis B and a fixed
per-item capacity N.

Kernel maps (the gather path) come from a dense voxel->row table per level:
`build_row_table` + `neighbor_map_table`.
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
    (z&1)`, `nchild` the occupied children of each coarse row. The dense
    path builds only `overflow` and leaves the rest None."""

    parent: Optional[torch.Tensor]  # i32[B, N_fine]
    kidx: Optional[torch.Tensor]  # i32[B, N_fine] in [0, 8)
    nchild: Optional[torch.Tensor]  # i32[B, N_coarse]
    overflow: torch.Tensor  # bool[B] coarse capacity exceeded


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
