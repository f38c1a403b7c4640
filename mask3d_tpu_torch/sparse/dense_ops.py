"""Dense-grid execution of sparse (submanifold) convolutions.

Rows of a level are scattered once into a dense grid `[B, X, Y, Z, C]`
(contiguous, the JAX package's layout), every convolution runs as a dense
`F.conv3d` on the channels-last-3d view `permute(0, 4, 1, 2, 3)`, and the
output is re-masked by the occupancy grid, so empty cells stay exactly 0 and
only occupied voxels carry values (submanifold semantics). Rows come back at
the tap points through the row-gather kernel (`row_gather.py`).

Weight layouts are PyTorch's: `[Cout, Cin, k, k, k]` for convolutions and
`[Cin, Cout, 2, 2, 2]` for transposed ones (`bridge.py` converts the JAX
package's `[K, Cin, Cout]` cube ravels).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mask3d_tpu_torch.sparse.core import INT32_MAX, PoolMap, SparseLevel, \
    pack_keys
from mask3d_tpu_torch.sparse.row_gather import row_gather


def _ncdhw(x):
    """[B, X, Y, Z, C] -> the [B, C, X, Y, Z] view F.conv3d takes."""
    return x.permute(0, 4, 1, 2, 3)


def _bxyzc(y):
    """[B, C, X, Y, Z] conv output -> contiguous [B, X, Y, Z, C]."""
    return y.permute(0, 2, 3, 4, 1).contiguous()


# from mask3d_tpu/sparse/dense_ops.py:36 static_keys
def static_keys(level: SparseLevel, grid_dims: Sequence[int]):
    """Linear cell index of each row in the static batch grid."""
    gx, gy, gz = grid_dims
    c = level.coords
    return (c[..., 0] * gy + c[..., 1]) * gz + c[..., 2]


# from mask3d_tpu/sparse/dense_ops.py:44 scatter_rows
def scatter_rows(feats, level: SparseLevel, grid_dims: Sequence[int]):
    """[B, N, C] rows -> [B, Gx, Gy, Gz, C] dense grid (zeros elsewhere)."""
    b, _, c = feats.shape
    gx, gy, gz = grid_dims
    cells = gx * gy * gz
    key = static_keys(level, grid_dims).long()
    key = torch.where(level.valid & (key < cells), key, cells)
    b_idx = torch.arange(b, device=feats.device)[:, None].expand_as(key)
    flat = feats.new_zeros((b, cells + 1, c))
    flat[b_idx, key] = feats
    return flat[:, :cells].reshape(b, gx, gy, gz, c)


# from mask3d_tpu/sparse/dense_ops.py:79 gather_rows (always the kernel)
def gather_rows(dense, level: SparseLevel, grid_dims: Sequence[int]):
    """[B, Gx, Gy, Gz, C] -> [B, N, C] rows of this level (padding zeroed)."""
    b, c = dense.shape[0], dense.shape[-1]
    cells = grid_dims[0] * grid_dims[1] * grid_dims[2]
    key = static_keys(level, grid_dims).clamp(0, cells - 1).to(torch.int32)
    return row_gather(dense.reshape(b, cells, c), key.contiguous(),
                      level.valid.contiguous())


# from mask3d_tpu/sparse/dense_ops.py:131 occupancy
def occupancy(level: SparseLevel, grid_dims: Sequence[int]):
    """f32[B, Gx, Gy, Gz, 1] indicator of occupied cells at this level."""
    ones = level.valid[..., None].float()
    return scatter_rows(ones, level, grid_dims)


# from mask3d_tpu/sparse/dense_ops.py:156 dense_conv_same
def dense_conv_same(x, weight, occ):
    """Same-stride submanifold conv. weight: [Cout, Cin, k, k, k]."""
    out = _bxyzc(F.conv3d(_ncdhw(x), weight, padding=weight.shape[-1] // 2))
    return out * occ


def _pad_odd(x, value=0.0):
    """Right-pad odd spatial dims of [B, X, Y, Z, C] by one cell."""
    pads = (0, 0, 0, x.shape[3] % 2, 0, x.shape[2] % 2, 0, x.shape[1] % 2)
    return F.pad(x, pads, value=value) if any(pads) else x


# from mask3d_tpu/sparse/dense_ops.py:422 dense_conv_down
def dense_conv_down(x, weight, occ_coarse):
    """Stride-2 kernel-2 conv; odd grid dims are zero-padded up.
    weight: [Cout, Cin, 2, 2, 2]."""
    out = _bxyzc(F.conv3d(_ncdhw(_pad_odd(x)), weight, stride=2))
    return out * occ_coarse


# from mask3d_tpu/sparse/dense_ops.py:444 dense_conv_tr
def dense_conv_tr(x, weight, occ_fine):
    """Transposed stride-2 kernel-2 conv: out[2i+d] = in[i] @ w[d].
    weight: [Cin, Cout, 2, 2, 2]. F.conv_transpose3d meets this contract
    as it is (no kernel flip); odd fine dims drop the overhang."""
    out = F.conv_transpose3d(_ncdhw(x), weight, stride=2)
    fx, fy, fz = occ_fine.shape[1:4]
    return _bxyzc(out[:, :, :fx, :fy, :fz]) * occ_fine


# from mask3d_tpu/sparse/dense_ops.py:465 dense_instance_norm
def dense_instance_norm(x, occ, gamma, beta, eps=1e-5):
    """Per-item per-channel norm over occupied cells (ME InstanceNorm).

    Unoccupied cells of `x` must be exactly 0. Stats: mean and
    var = max(E[x^2] - mean^2, 0) over occupied cells; output
    x*k + occ*t with k = gamma/sqrt(var+eps), t = beta - mean*k, so empty
    cells stay 0."""
    dims = (1, 2, 3)
    x32 = x.float()
    cnt = occ.float().sum(dim=dims, keepdim=True).clamp_min(1.0)
    mean = x32.sum(dim=dims, keepdim=True) / cnt
    sq = (x32 * x32).sum(dim=dims, keepdim=True) / cnt
    var = (sq - mean * mean).clamp_min(0.0)
    rs = torch.rsqrt(var + eps)
    k = (rs * gamma).to(x.dtype)
    t = (beta - mean * rs * gamma).to(x.dtype)
    return x * k + occ.to(x.dtype) * t


def _windows(x, value):
    """[B, X, Y, Z, C] -> [B, X/2, 2, Y/2, 2, Z/2, 2, C] after padding odd
    dims with `value`."""
    x = _pad_odd(x, value)
    b, gx, gy, gz, c = x.shape
    return x.reshape(b, gx // 2, 2, gy // 2, 2, gz // 2, 2, c)


# from mask3d_tpu/sparse/dense_ops.py:501 maxpool2
def maxpool2(occ):
    """2x2x2 stride-2 max pooling; odd dims pool their lone boundary slab
    (output = ceil(d/2))."""
    return _windows(occ, float("-inf")).amax(dim=(2, 4, 6))


# from mask3d_tpu/sparse/dense_ops.py:512 sumpool2
def sumpool2(x):
    """2x2x2 stride-2 sum pooling; odd dims pool their lone boundary slab."""
    return _windows(x, 0.0).sum(dim=(2, 4, 6))


# from mask3d_tpu/sparse/dense_ops.py:523 cell_coord_grid
def cell_coord_grid(grid_dims, batch: int, device="cpu"):
    """f32[B, Gx, Gy, Gz, 3] grid whose value at each cell is its own
    (x, y, z) cell index."""
    axes = [torch.arange(g, dtype=torch.float32, device=device)
            for g in grid_dims]
    g = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return g[None].expand((batch,) + g.shape)


# from mask3d_tpu/sparse/dense_ops.py:534 pooled_row_pyramid
def pooled_row_pyramid(grids, occ, levels, grid_dims):
    """Mean-pooled feature pyramid computed on dense grids: at each coarser
    level an occupied cell's value is the occupancy-weighted mean of its
    occupied children. Yields, per coarser level, the rows of every input
    grid gathered at that level's rows."""
    gs = list(grids)
    occ_f = occ[0].float()
    out = []
    for li in range(1, len(levels)):
        n = sumpool2(occ_f).clamp_min(1.0)
        gs = [(sumpool2(g.float()) / n).to(g.dtype) for g in gs]
        occ_f = occ[li].float()
        out.append([gather_rows(g, levels[li], grid_dims[li]) for g in gs])
    return out


# from mask3d_tpu/sparse/dense_ops.py:588 downsample_level_dense
def downsample_level_dense(level: SparseLevel, grid_dims, capacity: int,
                           occ_f, with_parent: bool = False):
    """Dense-grid construction of the stride-2 coarse level: coarse
    occupancy = maxpool of fine occupancy; coarse rows enumerate occupied
    cells in cell order (== sorted key order); `occ_f` is the fine level's
    occupancy grid. Rows past `capacity` are
    dropped and flagged in the returned overflow; the coarse occupancy keeps
    them (it pools the untruncated fine grid).

    Returns (coarse_level, PoolMap, occ_coarse). `with_parent` adds the
    per-row parents, child positions and child counts the gather path reads;
    the dense path pools on grids and leaves them None."""
    b = level.key.shape[0]
    gx, gy, gz = grid_dims
    cgx, cgy, cgz = (((gx - 1) >> 1) + 1, ((gy - 1) >> 1) + 1,
                     ((gz - 1) >> 1) + 1)
    cells_c = cgx * cgy * cgz
    dev = level.key.device

    occ_c = maxpool2(occ_f)  # [B, cgx, cgy, cgz, 1]
    flat_c = occ_c.reshape(b, cells_c)

    is_occ = flat_c > 0
    occ_i = is_occ.to(torch.int32)
    pos = torch.cumsum(occ_i, dim=1, dtype=torch.int32) - occ_i
    count_c = occ_i.sum(dim=1, dtype=torch.int32)
    overflow = count_c > capacity

    write_row = torch.where(is_occ & (pos < capacity), pos, capacity).long()
    b_idx = torch.arange(b, device=dev)[:, None].expand_as(write_row)
    cell = torch.arange(cells_c, dtype=torch.int32, device=dev)[None]
    cellrow = torch.zeros((b, capacity + 1), dtype=torch.int32, device=dev)
    cellrow[b_idx, write_row] = cell.expand(b, cells_c)
    cellrow = cellrow[:, :capacity]
    coords_c = torch.stack(
        [cellrow // (cgz * cgy), (cellrow // cgz) % cgy, cellrow % cgz],
        dim=-1,
    )
    count = torch.clamp(count_c, max=capacity)
    rows = torch.arange(capacity, dtype=torch.int32, device=dev)[None]
    valid_c = rows < count[:, None]

    dims_c = ((level.dims - 1) >> 1) + 1
    key_c = torch.where(valid_c, pack_keys(coords_c, dims_c[:, None, :]),
                        INT32_MAX).to(torch.int32)
    coarse = SparseLevel(key=key_c, coords=coords_c, valid=valid_c,
                         count=count, dims=dims_c, stride=level.stride * 2)
    parent = kidx = nchild = None
    if with_parent:
        # child counts: sum-pool the fine occupancy, written at the coarse
        # rows; parents: the coarse row position at each fine row's cell
        nchild = torch.zeros((b, capacity + 1), dtype=torch.int32, device=dev)
        nchild[b_idx, write_row] = sumpool2(occ_f).reshape(b, cells_c).to(
            torch.int32)
        nchild = nchild[:, :capacity]
        fc = level.coords
        pc = fc >> 1
        pcell = (pc[..., 0] * cgy + pc[..., 1]) * cgz + pc[..., 2]
        pcell = torch.where(level.valid, pcell, 0).long()
        ppos = torch.gather(pos, 1, pcell)
        parent = torch.where(level.valid & (ppos < capacity), ppos,
                             capacity).to(torch.int32)
        kidx = ((fc[..., 0] & 1) * 4 + (fc[..., 1] & 1) * 2
                + (fc[..., 2] & 1)).to(torch.int32)
    pool = PoolMap(parent=parent, kidx=kidx, nchild=nchild, overflow=overflow)
    return coarse, pool, occ_c
