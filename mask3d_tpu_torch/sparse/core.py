"""Sparse-voxel levels: per-item padded rows sorted by a linearized key.

Layout per item: rows sorted ascending by `key = (x*Dy + y)*Dz + z`;
padding rows carry key INT32_MAX and coords 0; `dims` is the per-item grid
extent at the level. Every tensor has a leading batch axis B and a fixed
per-item capacity N.
"""

from __future__ import annotations

import dataclasses

import torch

INT32_MAX = 2**31 - 1


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
