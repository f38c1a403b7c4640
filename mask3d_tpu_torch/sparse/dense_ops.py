"""Dense-grid execution of sparse (submanifold) convolutions.

Rows of a level are scattered once into a dense grid `[B, X, Y, Z, C]`
(contiguous, the JAX package's layout), every convolution runs as a dense
`F.conv3d` on the channels-last-3d view `permute(0, 4, 1, 2, 3)`, and the
output is re-masked by the occupancy grid, so empty cells stay exactly 0 and
only occupied voxels carry values (submanifold semantics). Rows come back at
the tap points through the row-gather kernel (`row_gather.py`).

Under sequence parallelism (`parallel/mesh.py`) a sharded level's grid is
this rank's x-slab `[B, x1 - x0, Gy, Gz, C]` (`parallel.mesh.Slab`): the
`*_slab` forms below scatter and gather only the slab's rows, the same-
stride conv reads its neighbours' halo planes, and the norm sums its
statistics over the ranks (`group=`). The stride-2 convs and pools need no
exchange: the slab plan aligns every slab with the one below it.

Weight layouts are PyTorch's: `[Cout, Cin, k, k, k]` for convolutions and
`[Cin, Cout, 2, 2, 2]` for transposed ones (`bridge.py` converts the JAX
package's `[K, Cin, Cout]` cube ravels). With `compute_dtype` (bf16) a conv
rounds its input and weight, accumulates in f32 and writes bf16, as the
JAX package's XLA convs do; the int8 convs are in `int8_ops.py`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mask3d_tpu_torch.parallel import comm
from mask3d_tpu_torch.sparse.core import INT32_MAX, PoolMap, SparseLevel, \
    child_row_table, pack_keys, unpack_keys
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
    gx, gy, gz = grid_dims
    cells = gx * gy * gz
    key = static_keys(level, grid_dims).long()
    return _scatter(feats, key, level.valid & (key < cells), (gx, gy, gz))


def _scatter(feats, key, write, dims):
    """Rows where `write` into a zero grid of `dims` at their cell `key`."""
    b, _, c = feats.shape
    cells = dims[0] * dims[1] * dims[2]
    key = torch.where(write, key, cells)
    b_idx = torch.arange(b, device=feats.device)[:, None].expand_as(key)
    flat = feats.new_zeros((b, cells + 1, c))
    flat[b_idx, key] = feats
    return flat[:, :cells].reshape(b, *dims, c)


def _slab_keys(level: SparseLevel, grid_dims, slab):
    """(cell of each row in the slab's grid, bool rows inside the slab)."""
    from mask3d_tpu_torch.sparse.context import slab_rows

    gy, gz = grid_dims[1], grid_dims[2]
    key = static_keys(level, grid_dims).long() - slab.x0 * gy * gz
    return key, slab_rows(level, slab.x0, slab.x1)


def scatter_rows_slab(feats, level: SparseLevel, grid_dims, slab):
    """[B, N, C] rows -> this rank's x-slab [B, x1 - x0, Gy, Gz, C] of the
    grid: only the rows inside the slab are written."""
    key, inside = _slab_keys(level, grid_dims, slab)
    return _scatter(feats, key, inside,
                    (slab.x1 - slab.x0, grid_dims[1], grid_dims[2]))


def gather_rows_slab(dense, level: SparseLevel, grid_dims, slab, chunks):
    """This rank's x-slab -> this rank's chunk of the level's rows [B, hi -
    lo, C] (`chunks`, `parallel.mesh.RowChunks`): the row-gather kernel
    takes the slab's rows (zeros elsewhere) and a reduce-scatter over the
    slab's group leaves each rank its chunk of their sum, with its
    gradient (`comm.reduce_scatter_rows`)."""
    b, c = dense.shape[0], dense.shape[-1]
    cells = dense.shape[1] * dense.shape[2] * dense.shape[3]
    key, inside = _slab_keys(level, grid_dims, slab)
    key = key.clamp(0, cells - 1).to(torch.int32)
    rows = row_gather(dense.reshape(b, cells, c), key.contiguous(),
                      inside.contiguous())
    return comm.reduce_scatter_rows(rows, chunks.bounds(level.capacity),
                                    slab.group)


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


def _cast(x, weight, compute_dtype):
    """Round the conv input and weight to `compute_dtype` (None: as they
    are). The conv then accumulates in f32 and writes its output once, in
    that dtype."""
    if compute_dtype is None:
        return x, weight
    return x.to(compute_dtype), weight.to(compute_dtype)


def _mask(out, occ):
    """Re-mask by occupancy in the output's dtype (a bf16 output times an
    f32 mask would promote the grid back to f32)."""
    return out * occ.to(out.dtype)


# from mask3d_tpu/sparse/dense_ops.py:156 dense_conv_same (no bias)
def dense_conv_same(x, weight, occ, compute_dtype=None):
    """Same-stride submanifold conv. weight: [Cout, Cin, k, k, k]."""
    x, weight = _cast(x, weight, compute_dtype)
    out = _bxyzc(F.conv3d(_ncdhw(x), weight, padding=weight.shape[-1] // 2))
    return _mask(out, occ)


def dense_conv_same_slab(x, weight, occ, slab, compute_dtype=None):
    """`dense_conv_same` on this rank's x-slab: the k // 2 planes on either
    side come from the neighbouring ranks' slabs (`comm.halo`, zeros at the
    grid's outer faces), so the slab's output equals the whole grid's
    there."""
    x, weight = _cast(x, weight, compute_dtype)
    p = weight.shape[-1] // 2
    if p:
        x = comm.halo(x, p, slab.group)
    out = _bxyzc(F.conv3d(_ncdhw(x), weight, padding=(0, p, p)))
    return _mask(out, occ)


def _fold(x):
    """[B, X, Y, Z, C] -> the z-folded [B, Z*C, X, Y] (channel z*C + c)
    that F.conv2d takes."""
    b, gx, gy, gz, c = x.shape
    return x.permute(0, 3, 4, 1, 2).reshape(b, gz * c, gx, gy)


def _unfold(xf, gz):
    """The z-folded [B, Z*C, X, Y] -> contiguous [B, X, Y, Z, C]."""
    b, zc, gx, gy = xf.shape
    return xf.reshape(b, gz, zc // gz, gx, gy).permute(0, 3, 4, 1, 2) \
        .contiguous()


def _zfold_weight(weight, gz):
    """A k^3 weight [Cout, Cin, k, k, k] as the banded 2D weight
    [Z*Cout, Z*Cin, k, k] of the z-folded conv: w2d[z_out*Cout + co,
    z_in*Cin + ci, dx, dy] = weight[co, ci, dx, dy, z_in - z_out + k//2],
    zero outside the band (so the fold adds exact-zero products only)."""
    cout, cin, k = weight.shape[0], weight.shape[1], weight.shape[-1]
    z = torch.arange(gz, device=weight.device)
    # band[dz, z_in, z_out] = 1 iff z_in == z_out + dz - k // 2
    band = torch.stack([z[:, None] == z[None, :] + dz - k // 2
                        for dz in range(k)]).to(weight.dtype)
    return torch.einsum("dio,fcxyd->oficxy", band, weight).reshape(
        gz * cout, gz * cin, k, k)


# from mask3d_tpu/sparse/dense_ops.py:259 _zfold_conv
def _zfold_conv(xf, weight, gz):
    """A k^3 same-stride conv as a banded 2D conv over the z-folded layout
    [B, Z*Cin, X, Y] -> [B, Z*Cout, X, Y] (no mask): z lives in the
    channels, so the contraction is (k^2 Z Cin) x (Z Cout)."""
    k = weight.shape[-1]
    return F.conv2d(xf, _zfold_weight(weight, gz), padding=k // 2)


# from mask3d_tpu/sparse/dense_ops.py:294 dense_conv_same_zfold (no bias)
def dense_conv_same_zfold(x, weight, occ, compute_dtype=None):
    """`dense_conv_same` through the z-folded conv: the same function, the
    banded weight's zeros aside."""
    x, weight = _cast(x, weight, compute_dtype)
    out = _unfold(_zfold_conv(_fold(x), weight, x.shape[3]), x.shape[3])
    return _mask(out, occ)


# from mask3d_tpu/sparse/dense_ops.py:353 dense_basic_stage_folded
def dense_basic_stage_folded(x, occ, blocks, compute_dtype=None, eps=1e-5):
    """A stack of identity-residual BasicBlocks (Cin == Cout == C) run
    whole in the z-folded layout: one fold in, per block [banded conv ->
    norm -> relu -> banded conv -> norm -> + residual -> relu], one unfold
    out. The norm statistics are fold-aware (sums over x, y per folded
    channel, then over z), as the JAX package's are; the result equals the
    unfolded `dense_conv_same` / `dense_instance_norm` chain up to float
    rounding. blocks: per block a dict of w1, g1, b1, w2, g2, b2 (weights
    [C, C, k, k, k], norm affines [C])."""
    b, gx, gy, gz, c = x.shape
    dt = compute_dtype or x.dtype
    xf = _fold(x.to(dt))
    occf = occ[..., 0].permute(0, 3, 1, 2)  # [B, Z, X, Y]
    occy = occf.to(dt).repeat_interleave(c, dim=1)  # [B, Z*C, X, Y]
    cnt = occf.float().sum(dim=(1, 2, 3)).clamp_min(1.0)[:, None]  # [B, 1]

    def norm(yf, gamma, beta):
        """The masked norm's affine (k, t), tiled over the fold."""
        ym = (yf * occy).float()
        s1 = ym.sum(dim=(2, 3)).reshape(b, gz, c).sum(dim=1)
        s2 = (ym * ym).sum(dim=(2, 3)).reshape(b, gz, c).sum(dim=1)
        mean = s1 / cnt
        var = (s2 / cnt - mean * mean).clamp_min(0.0)
        rs = torch.rsqrt(var + eps)
        kk = (rs * gamma).to(dt).repeat(1, gz)[..., None, None]
        tt = (beta - mean * rs * gamma).to(dt).repeat(1, gz)[..., None, None]
        return kk, tt

    for blk in blocks:
        y1 = _zfold_conv(xf, blk["w1"].to(dt), gz)
        k1, t1 = norm(y1, blk["g1"], blk["b1"])
        h = torch.relu(y1 * occy * k1 + occy * t1)
        y2 = _zfold_conv(h, blk["w2"].to(dt), gz)
        k2, t2 = norm(y2, blk["g2"], blk["b2"])
        xf = torch.relu(y2 * occy * k2 + occy * t2 + xf)
    return _unfold(xf, gz)


def _pad_odd(x, value=0.0):
    """Right-pad odd spatial dims of [B, X, Y, Z, C] by one cell."""
    pads = (0, 0, 0, x.shape[3] % 2, 0, x.shape[2] % 2, 0, x.shape[1] % 2)
    return F.pad(x, pads, value=value) if any(pads) else x


# from mask3d_tpu/sparse/dense_ops.py:422 dense_conv_down (no bias)
def dense_conv_down(x, weight, occ_coarse, compute_dtype=None):
    """Stride-2 kernel-2 conv; odd grid dims are zero-padded up.
    weight: [Cout, Cin, 2, 2, 2]."""
    x, weight = _cast(x, weight, compute_dtype)
    out = _bxyzc(F.conv3d(_ncdhw(_pad_odd(x)), weight, stride=2))
    return _mask(out, occ_coarse)


# from mask3d_tpu/sparse/dense_ops.py:444 dense_conv_tr (no bias)
def dense_conv_tr(x, weight, occ_fine, compute_dtype=None):
    """Transposed stride-2 kernel-2 conv: out[2i+d] = in[i] @ w[d].
    weight: [Cin, Cout, 2, 2, 2]. F.conv_transpose3d meets this contract
    as it is (no kernel flip); odd fine dims drop the overhang."""
    x, weight = _cast(x, weight, compute_dtype)
    out = F.conv_transpose3d(_ncdhw(x), weight, stride=2)
    fx, fy, fz = occ_fine.shape[1:4]
    return _mask(_bxyzc(out[:, :, :fx, :fy, :fz]), occ_fine)


# from mask3d_tpu/sparse/dense_ops.py:465 dense_instance_norm
def dense_instance_norm(x, occ, gamma, beta, eps=1e-5, group=None):
    """Per-item per-channel norm over occupied cells (ME InstanceNorm).

    Unoccupied cells of `x` must be exactly 0. Stats: mean and
    var = max(E[x^2] - mean^2, 0) over occupied cells; output
    x*k + occ*t with k = gamma/sqrt(var+eps), t = beta - mean*k, so empty
    cells stay 0. With `group` (an x-slab of a sharded level) the count
    and sums are summed over the group's ranks, with their gradient, in
    one all-reduce."""
    dims = (1, 2, 3)
    x32 = x.float()
    cnt = occ.float().sum(dim=dims, keepdim=True)
    s1 = x32.sum(dim=dims, keepdim=True)
    s2 = (x32 * x32).sum(dim=dims, keepdim=True)
    if group is not None:
        c = x.shape[-1]
        s = comm.sum_over(torch.cat([cnt, s1, s2], dim=-1), group)
        cnt, s1, s2 = s[..., :1], s[..., 1:1 + c], s[..., 1 + c:]
    cnt = cnt.clamp_min(1.0)
    mean = s1 / cnt
    sq = s2 / cnt
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
def cell_coord_grid(grid_dims, batch: int, device="cpu", x0: int = 0):
    """f32[B, Gx, Gy, Gz, 3] grid whose value at each cell is its own
    (x, y, z) cell index; `x0` offsets x (an x-slab starting there)."""
    axes = [torch.arange(g, dtype=torch.float32, device=device)
            for g in grid_dims]
    axes[0] = axes[0] + x0
    g = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return g[None].expand((batch,) + g.shape)


# from mask3d_tpu/sparse/dense_ops.py:534 pooled_row_pyramid
def pooled_row_pyramid(grids, occ, levels, grid_dims, plan=None,
                       chunks=None):
    """Mean-pooled feature pyramid computed on dense grids: at each coarser
    level an occupied cell's value is the occupancy-weighted mean of its
    occupied children. Yields, per coarser level, the rows of every input
    grid gathered at that level's rows. With a slab `plan`
    (`parallel.mesh.slab_plan`) the grids are level 0's x-slabs: sharded
    levels pool on their slabs (the plan aligns them), the first whole
    level pools the gathered grid of the last sharded one, and every
    level's rows come back as this rank's chunk of them (`chunks`,
    `parallel.mesh.RowChunks`, which a plan needs). No gradient flows
    through the sharded form."""
    plan = plan or [None] * len(levels)

    def cut(o, s):
        return o if s is None else o[:, s.x0:s.x1]

    gs = list(grids)
    occ_f = cut(occ[0], plan[0]).float()
    out = []
    for li in range(1, len(levels)):
        s, fine = plan[li], plan[li - 1]
        if s is None and fine is not None:
            gs = [comm.gather_x(g, fine.bounds, fine.group, name="pyramid")
                  for g in gs]
            occ_f = occ[li - 1].float()
        n = sumpool2(occ_f).clamp_min(1.0)
        gs = [(sumpool2(g.float()) / n).to(g.dtype) for g in gs]
        occ_f = cut(occ[li], s).float()
        lv = levels[li]
        if s is not None:
            rows = [gather_rows_slab(g, lv, grid_dims[li], s, chunks)
                    for g in gs]
        else:
            rows = [gather_rows(g, lv, grid_dims[li]) for g in gs]
            if chunks is not None:
                rows = [chunks.take(r, lv.capacity) for r in rows]
        out.append(rows)
    return out


# from mask3d_tpu/sparse/dense_ops.py:572 level_from_keys
def level_from_keys(keys, raw_count, dims, stride: int, capacity: int
                    ) -> SparseLevel:
    """A coarse level from host-computed sorted keys
    (`data/transfer.py::coarse_pyramid_host`), with the padding of
    `downsample_level_dense`: key INT32_MAX and coords 0 on padding rows,
    the count clamped to the capacity; the two builds are bit-identical."""
    count = torch.clamp(raw_count, max=capacity)
    rows = torch.arange(capacity, dtype=torch.int32, device=keys.device)[None]
    valid = rows < count[:, None]
    key = torch.where(valid, keys, INT32_MAX).to(torch.int32)
    coords = torch.where(valid[..., None], unpack_keys(keys, dims), 0)
    return SparseLevel(key=key, coords=coords.to(torch.int32), valid=valid,
                       count=count, dims=dims, stride=stride)


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
    parent = kidx = nchild = rows = None
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
        rows = child_row_table(parent, kidx, capacity)
    pool = PoolMap(parent=parent, kidx=kidx, nchild=nchild, overflow=overflow,
                   child_rows=rows)
    return coarse, pool, occ_c
