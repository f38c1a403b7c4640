"""Res16UNet sparse-voxel backbones (fp32 or bf16 on every impl, with int8
eval convs and the fused int8 block chain on `dense`, the bf16 sparse-conv
kernel on `gather_pallas`).

A 4-stage stride-2 encoder and a 4-stage transposed-conv decoder with skip
concatenations and InstanceNorm everywhere. Four executions share one
parameter layout (`impl`, the JAX package's `backbone_impl`):

- `dense`: dense convolutions re-masked by occupancy on per-level grids
  (`sparse/dense_ops.py`), in `compute_dtype` (None = f32, or bf16). The
  int8 eval stack rides on it: `int8_stride1` runs every same-stride conv
  with min(Cin, Cout) >= 96 as an int8 conv (`sparse/int8_ops.py`),
  `int8_act_sigma` > 0 gives those convs static activation scales from the
  producing norms' affines, `int8_residual` keeps intermediate block
  outputs as int8 `QGrid`s, and `pallas_chain` runs the eligible stride-1
  stages through the fused int8 chain (`sparse/chain.py`);
- `gather`: row-space gather-matmul convolutions over kernel maps and
  stride-2 convs over PoolMaps (`sparse/ops.py`), in `compute_dtype`;
- `gather_pallas`: `gather` whose same-stride convs run the bf16 sparse-conv
  kernel (`sparse/sparse_conv.py`) on every level that `supports()` its
  capacity, its f32 output cast back to the input's dtype;
- `bricked`: `dense` with level 0 as occupied dense bricks
  (`sparse/brick_ops.py`) and every coarser level a dense grid, for scans
  whose level-0 grid is too large for `dense`; B=1, no int8.

The JAX package's `pallas_window_mode` and `pallas_conv_select` schedule
its TPU kernel and leave its outputs as they are: the port runs its one
sparse-conv kernel for each of their values (`models/mask3d.py` checks
them).

With `sp_axis` under an active mesh that carries it (`parallel/mesh.py`),
`dense` runs on x-slabs of its grids over the `sp` ranks (`_SlabCtx`), with
every block type, the gate and the int8 knobs; the other impls run whole on
every rank.

Returns `(out_rows, feature_maps, out_grid)`: stride-1 rows [B, N, PLANES[7]],
the five pyramid outputs as rows at strides [16, 8, 4, 2, 1] (whole on
every rank under sp, or with `chunks` this rank's chunk of each level's
rows on `dense`), and the final level-0 grid for the pooled pyramid (this
rank's x-slab under sp; None on the other impls).

Blocks are basic (two 3^3 convs) or, on `Res16UNet50`/`101`, bottlenecks
(1x1 reduce, 3^3, 1x1 expand x4, so every feature map is PLANES x 4 wide),
optionally with a squeeze-excitation gate (`SE`, the ResUNet zoo's
`SEResUNet*` in `models/resunet.py`). `fold_small_stages` runs the
identity-residual stages of <= 32 channels on `dense` in the z-folded
layout (`dense_ops.dense_basic_stage_folded`). The int8 stack runs every
block type on `dense` (the fused chain only on basic blocks without the
gate and without sp, as the JAX package gates it).

Parameters are named after the JAX package's (`conv0p1s1`, `bn0`,
`block1_0_conv1`, `block1_0_norm1`, ...): `convs[name].weight` holds the
kernel in PyTorch's layout, `norms[name]` the InstanceNorm gamma/beta and
`se[block].fc1`/`fc2` a gate's two linear layers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mask3d_tpu_torch.parallel import comm
from mask3d_tpu_torch.parallel.mesh import sp_group, slab_plan
from mask3d_tpu_torch.sparse import brick_ops, chain, dense_ops, ops
from mask3d_tpu_torch.sparse import sparse_conv as sc
from mask3d_tpu_torch.sparse.context import SparseBatch
from mask3d_tpu_torch.sparse.int8_ops import QGrid, act_bound, \
    dense_conv_same_int8, dequantize, quantize_static, weight_rows

IMPLS = ("dense", "gather", "gather_pallas", "bricked")


class Conv(nn.Module):
    """A conv weight: [Cout, Cin, k, k, k], or [Cin, Cout, 2, 2, 2] for a
    transposed conv; a bias [Cout] only where asked (the ResUNet head's
    last 1x1)."""

    def __init__(self, k: int, cin: int, cout: int, transpose=False,
                 bias: bool = False):
        super().__init__()
        shape = (cin, cout) if transpose else (cout, cin)
        self.weight = nn.Parameter(torch.empty(shape + (k, k, k)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.fan_in = k ** 3 * cin


class Norm(nn.Module):
    """InstanceNorm affine parameters (gamma, beta)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


def _kernel_rows(conv: Conv):
    """A conv weight [Cout, Cin, k, k, k] as [k^3, Cin, Cout] in
    `cube_offsets` order (the inverse of `bridge.py`'s cube transpose)."""
    return weight_rows(conv.weight)


def _kernel_rows_tr(conv: Conv):
    """A transposed weight [Cin, Cout, 2, 2, 2] as [8, Cin, Cout] by child
    position (x&1)*4 + (y&1)*2 + (z&1)."""
    w = conv.weight
    return w.permute(2, 3, 4, 0, 1).reshape(8, w.shape[0], w.shape[1])


# from mask3d_tpu/models/backbone.py:54 _GatherCtx (the bf16 sparse-conv
# kernel on eligible levels with use_kernel)
class _GatherCtx:
    """Row-form execution over kernel maps: features stay [B, N, C] rows of
    their level. With `use_kernel`, same-stride convs on levels whose
    capacity `supports()` run the bf16 sparse-conv kernel, its f32 output
    cast to the input's dtype; the others, and every stride-2 and 1x1
    conv, run the gather-matmul in `compute_dtype` (None: the input's)."""

    def __init__(self, sb: SparseBatch, use_kernel: bool,
                 compute_dtype=None):
        self.sb = sb
        self.use_kernel = use_kernel
        self.dt = compute_dtype

    def scatter(self, feats_rows, level_idx):
        return feats_rows  # rows are already per-level

    def _conv(self, x, conv: Conv, idx, ok):
        w = _kernel_rows(conv)
        if self.use_kernel and sc.supports(x.shape[1]):
            return sc.sparse_conv(x, w, idx, ok).to(x.dtype)
        return ops.sparse_conv(x, w, idx, ok, compute_dtype=self.dt)

    def conv_in(self, x, conv: Conv):
        return self._conv(x, conv, self.sb.nbr0_idx, self.sb.nbr0_ok)

    def conv3(self, x, conv: Conv, level_idx, bound=None):
        return self._conv(x, conv, self.sb.nbr_idx[level_idx],
                          self.sb.nbr_ok[level_idx])

    def conv1x1(self, x, conv: Conv, level_idx, bound=None):
        w = conv.weight
        w = w.reshape(w.shape[0], w.shape[1]).t()
        if self.dt is None:
            return x @ w
        # bf16 operands, f32 sums, one bf16 write
        return (x.to(self.dt).float() @ w.to(self.dt).float()).to(self.dt)

    def conv_down(self, x, conv: Conv, fine_idx):
        return ops.sparse_conv_down(x, _kernel_rows(conv),
                                    self.sb.pools[fine_idx],
                                    self.sb.levels[fine_idx + 1].capacity,
                                    compute_dtype=self.dt)

    def conv_tr(self, x, conv: Conv, coarse_idx):
        return ops.sparse_conv_tr(x, _kernel_rows_tr(conv),
                                  self.sb.pools[coarse_idx - 1],
                                  self.sb.levels[coarse_idx - 1].valid,
                                  compute_dtype=self.dt)

    def norm(self, x, norm: Norm, level_idx):
        return ops.instance_norm(x, self.sb.levels[level_idx].valid,
                                 norm.weight, norm.bias)

    def block_join(self, out, residual, level_idx, bound=None,
                   want_q=False):
        return torch.relu(out + residual)

    def rows(self, x, level_idx):
        return x

    # from mask3d_tpu/models/backbone.py:140 global_mean
    def global_mean(self, x, level_idx):
        """Per-item mean over the valid rows -> [B, 1, C]."""
        valid = self.sb.levels[level_idx].valid[..., None]
        s = torch.where(valid, x, 0).sum(dim=1, keepdim=True)
        cnt = valid.to(x.dtype).sum(dim=1, keepdim=True).clamp_min(1)
        return s / cnt


# from mask3d_tpu/models/backbone.py:150 _DenseCtx (no sp)
class _DenseCtx:
    """Dense-grid execution: features live as [B, Gx, Gy, Gz, C] per level,
    in `compute_dtype` (None = f32) after the first conv."""

    def __init__(self, sb: SparseBatch, grid_dims, compute_dtype=None,
                 int8_stride1: bool = False, int8_act_sigma: float = 0.0,
                 int8_residual: bool = False):
        self.sb = sb
        self.grid_dims = list(grid_dims)
        self.occ = list(sb.occ)
        self.dt = compute_dtype
        self.int8_l0 = int8_stride1
        self.int8_sigma = float(int8_act_sigma)
        self.int8_res = bool(int8_residual) and int8_stride1 and \
            self.int8_sigma > 0

    def scatter(self, feats_rows, level_idx):
        return dense_ops.scatter_rows(
            feats_rows, self.sb.levels[level_idx], self.grid_dims[level_idx])

    def _int8(self, conv: Conv) -> bool:
        """int8 eval conv: only the widths >= 96 (the JAX package's
        MXU-bound gate), on every level."""
        w = conv.weight
        return self.int8_l0 and min(w.shape[0], w.shape[1]) >= 96

    def conv3(self, x, conv: Conv, level_idx, bound=None):
        """Same-stride conv (k 3, or k 1 as `conv1x1`); `bound` is the static
        bound on |x|, used when `int8_act_sigma` > 0."""
        occ = self.occ[level_idx]
        if not self._int8(conv):
            if isinstance(x, QGrid):
                x = dequantize(x, self.dt or torch.float32)
            return dense_ops.dense_conv_same(x, conv.weight, occ,
                                             compute_dtype=self.dt)
        return dense_conv_same_int8(
            x, conv.weight, occ, out_dtype=self.dt or torch.float32,
            act_bound=bound if self.int8_sigma > 0 else None)

    def conv_in(self, x, conv: Conv):
        return self.conv3(x, conv, 0)

    conv1x1 = conv3  # k=1 weights: the residual downsample

    def conv_down(self, x, conv: Conv, fine_idx):
        return dense_ops.dense_conv_down(x, conv.weight,
                                         self.occ[fine_idx + 1],
                                         compute_dtype=self.dt)

    def conv_tr(self, x, conv: Conv, coarse_idx):
        return dense_ops.dense_conv_tr(x, conv.weight,
                                       self.occ[coarse_idx - 1],
                                       compute_dtype=self.dt)

    def norm(self, x, norm: Norm, level_idx):
        return dense_ops.dense_instance_norm(x, self.occ[level_idx],
                                             norm.weight, norm.bias)

    # from mask3d_tpu/models/backbone.py:287 block_join
    def block_join(self, out, residual, level_idx, bound=None,
                   want_q=False):
        """relu(out + residual); with `int8_residual` an intermediate block
        output (`want_q`) comes back only as a statically quantized QGrid,
        the next block's int8 conv input and residual."""
        if isinstance(residual, QGrid):
            residual = dequantize(residual, out.dtype)
        y = torch.relu(out + residual)
        if want_q and self.int8_res and bound is not None:
            return quantize_static(y, bound)
        return y

    def rows(self, x, level_idx):
        return dense_ops.gather_rows(x, self.sb.levels[level_idx],
                                     self.grid_dims[level_idx])

    # from mask3d_tpu/models/backbone.py:314 global_mean
    def global_mean(self, x, level_idx):
        """Per-item mean over the occupied cells -> [B, 1, 1, 1, C]."""
        occ = self.occ[level_idx]
        s = (x * occ).sum(dim=(1, 2, 3), keepdim=True)
        cnt = occ.to(x.dtype).sum(dim=(1, 2, 3), keepdim=True).clamp_min(1)
        return s / cnt


# from mask3d_tpu/models/backbone.py:150 _DenseCtx (sp_axis set under an
# active mesh that carries it)
class _SlabCtx(_DenseCtx):
    """`_DenseCtx` under sequence parallelism: each level that the slab
    plan shards (`parallel.mesh.slab_plan`) lives as this rank's x-slab;
    the others stay whole on every rank, as the JAX package's
    `sp_min_per_shard` keeps them. Same-stride convs exchange halo planes,
    norms sum their statistics over `sp`, the stride-2 convs stay local on
    aligned slabs, and the step from the last sharded level to the first
    whole one gathers the slabs (and the transposed conv back slices them).
    The int8 convs quantize with the whole grid's scale (the dynamic
    absmax max-reduced over `sp`, or the static bound) and read their halo
    planes quantized, a QGrid's as its int8 planes. `rows()` hands the
    decoder whole rows on every rank, or with `chunks`
    (`parallel.mesh.RowChunks`, inference) this rank's chunk of them.
    Gradients follow `parallel/comm.py`'s convention: the backbone's
    parameters get partial gradients, summed over `sp` by the train
    step."""

    def __init__(self, sb: SparseBatch, grid_dims, plan, group,
                 compute_dtype=None, chunks=None, **int8):
        super().__init__(sb, grid_dims, compute_dtype, **int8)
        self.plan = plan
        self.group = group
        self.chunks = chunks
        self.occ = [o if s is None else o[:, s.x0:s.x1]
                    for o, s in zip(sb.occ, plan)]

    def scatter(self, feats_rows, level_idx):
        s = self.plan[level_idx]
        if s is None:
            return super().scatter(feats_rows, level_idx)
        return dense_ops.scatter_rows_slab(
            feats_rows, self.sb.levels[level_idx], self.grid_dims[level_idx],
            s)

    def conv3(self, x, conv: Conv, level_idx, bound=None):
        s = self.plan[level_idx]
        if s is None:
            return super().conv3(x, conv, level_idx, bound=bound)
        occ = self.occ[level_idx]
        if not self._int8(conv):
            if isinstance(x, QGrid):
                x = dequantize(x, self.dt or torch.float32)
            return dense_ops.dense_conv_same_slab(
                x, conv.weight, occ, s, compute_dtype=self.dt)
        bound = bound if self.int8_sigma > 0 else None
        if bound is None and not isinstance(x, QGrid):
            bound = self._absmax(x, s)
        p = conv.weight.shape[-1] // 2
        if p:  # the halo planes, then the conv on the padded slab, cropped
            x = (QGrid(comm.halo(x.q, p, s.group), x.scale)
                 if isinstance(x, QGrid) else comm.halo(x, p, s.group))
            occ = torch.nn.functional.pad(occ, (0, 0, 0, 0, 0, 0, p, p))
        out = dense_conv_same_int8(x, conv.weight, occ,
                                   out_dtype=self.dt or torch.float32,
                                   act_bound=bound)
        return out[:, p:out.shape[1] - p].contiguous() if p else out

    conv1x1 = conv3  # k=1: no halo

    def _absmax(self, x, s):
        """Per channel, the whole grid's max |x|: the dynamic int8 scale of
        a slab, as GSPMD reduces the JAX package's over the sharded x."""
        return comm.max_over(x.float().abs().amax(dim=(0, 1, 2, 3)),
                             s.group, name="int8_absmax")

    def conv_down(self, x, conv: Conv, fine_idx):
        fine, coarse = self.plan[fine_idx], self.plan[fine_idx + 1]
        if fine is not None and coarse is None:
            x = comm.gather_slabs(x, fine.bounds, fine.group)
        return super().conv_down(x, conv, fine_idx)

    def conv_tr(self, x, conv: Conv, coarse_idx):
        coarse, fine = self.plan[coarse_idx], self.plan[coarse_idx - 1]
        if coarse is None and fine is not None:
            whole = dense_ops.dense_conv_tr(x, conv.weight,
                                            self.sb.occ[coarse_idx - 1],
                                            compute_dtype=self.dt)
            return whole[:, fine.x0:fine.x1].contiguous()
        return super().conv_tr(x, conv, coarse_idx)

    def norm(self, x, norm: Norm, level_idx):
        s = self.plan[level_idx]
        return dense_ops.dense_instance_norm(
            x, self.occ[level_idx], norm.weight, norm.bias,
            group=None if s is None else s.group)

    def rows(self, x, level_idx):
        s = self.plan[level_idx]
        level = self.sb.levels[level_idx]
        if s is None and self.chunks is not None:
            return self.chunks.take(super().rows(x, level_idx),
                                    level.capacity)
        if s is None:
            # a whole level: the decoder's gradient counted once over sp
            return comm.to_partial(super().rows(x, level_idx), self.group)
        return dense_ops.gather_rows_slab(x, level,
                                          self.grid_dims[level_idx], s,
                                          self.chunks)

    # from mask3d_tpu/models/backbone.py:314 global_mean (GSPMD's sum over
    # the sharded x axis)
    def global_mean(self, x, level_idx):
        """Per-item mean over the occupied cells of the whole grid: the
        slab's sums and counts summed over `sp`, then `_DenseCtx`'s
        arithmetic (the count in x's dtype, so bf16 rounds a count above
        256 as the whole grid's sum does)."""
        s = self.plan[level_idx]
        if s is None:
            return super().global_mean(x, level_idx)
        occ = self.occ[level_idx]
        tot = (x * occ).sum(dim=(1, 2, 3), keepdim=True)
        part = torch.cat([occ.float().sum(dim=(1, 2, 3), keepdim=True),
                          tot.float()], dim=-1)
        part = comm.sum_over(part, s.group)
        cnt = part[..., :1].to(x.dtype).clamp_min(1)
        return part[..., 1:].to(tot.dtype) / cnt


# from mask3d_tpu/models/backbone.py:324 _BrickCtx
class _BrickCtx:
    """Bricked execution: level 0 as occupied dense bricks
    (`sparse/brick_ops.py`, [NB + 1, bx, by, bz, C]), every coarser level a
    dense grid as in `_DenseCtx`, in `compute_dtype`. B=1 and no int8.
    Building the brick tables sets `sb.brick_overflow`."""

    def __init__(self, sb: SparseBatch, grid_dims, compute_dtype=None,
                 brick_dims=(16, 16, 8), brick_capacity: int = 8192):
        if sb.levels[0].batch_size != 1:
            raise ValueError(f"backbone_impl=bricked runs one scene a "
                             f"forward (B=1), got B={sb.levels[0].batch_size}")
        self.sb = sb
        self.dt = compute_dtype
        self.grid_dims = list(grid_dims)
        self.spec = brick_ops.make_brick_spec(grid_dims[0], brick_dims,
                                              brick_capacity)
        self.tables = brick_ops.build_tables(sb.levels[0], self.spec)
        sb.brick_overflow = self.tables.overflow
        self.occ_b = brick_ops.occupancy(self.tables, self.spec,
                                         sb.levels[0].valid)
        self.occ = list(sb.occ)  # levels 1-4; level 0's is occ_b

    def scatter(self, feats_rows, level_idx):
        return brick_ops.scatter_rows(feats_rows, self.tables, self.spec)

    def conv3(self, x, conv: Conv, level_idx, bound=None):
        if level_idx == 0:
            return brick_ops.conv_same(x, conv.weight, self.occ_b,
                                       self.tables, self.spec,
                                       compute_dtype=self.dt)
        return dense_ops.dense_conv_same(x, conv.weight, self.occ[level_idx],
                                         compute_dtype=self.dt)

    def conv_in(self, x, conv: Conv):
        return self.conv3(x, conv, 0)

    def conv1x1(self, x, conv: Conv, level_idx, bound=None):
        # a k=1 conv per cell; level 0's bricks take the same dense conv,
        # re-masked by the brick occupancy (zeros in, zeros out)
        occ = self.occ_b if level_idx == 0 else self.occ[level_idx]
        return dense_ops.dense_conv_same(x, conv.weight, occ,
                                         compute_dtype=self.dt)

    def conv_down(self, x, conv: Conv, fine_idx):
        if fine_idx == 0:
            return brick_ops.conv_down(x, conv.weight, self.occ[1],
                                       self.tables, self.spec,
                                       self.grid_dims[1],
                                       compute_dtype=self.dt)
        return dense_ops.dense_conv_down(x, conv.weight,
                                         self.occ[fine_idx + 1],
                                         compute_dtype=self.dt)

    def conv_tr(self, x, conv: Conv, coarse_idx):
        if coarse_idx == 1:
            return brick_ops.conv_tr(x, conv.weight, self.occ_b, self.tables,
                                     self.spec, compute_dtype=self.dt)
        return dense_ops.dense_conv_tr(x, conv.weight,
                                       self.occ[coarse_idx - 1],
                                       compute_dtype=self.dt)

    def norm(self, x, norm: Norm, level_idx):
        if level_idx == 0:
            return brick_ops.instance_norm(x, self.occ_b, norm.weight,
                                           norm.bias)
        return dense_ops.dense_instance_norm(x, self.occ[level_idx],
                                             norm.weight, norm.bias)

    def block_join(self, out, residual, level_idx, bound=None,
                   want_q=False):
        return torch.relu(out + residual)

    def rows(self, x, level_idx):
        if level_idx == 0:
            return brick_ops.gather_rows(x, self.tables, self.spec,
                                         self.sb.levels[0].valid)
        return dense_ops.gather_rows(x, self.sb.levels[level_idx],
                                     self.grid_dims[level_idx])

    # from mask3d_tpu/models/backbone.py:433 global_mean
    def global_mean(self, x, level_idx):
        """The scene's mean over its occupied cells (B=1) ->
        [1, 1, 1, 1, C]: level 0 over the bricks' occupied cells."""
        if level_idx == 0:
            occ = self.occ_b.to(x.dtype)
            s = (x * occ).sum(dim=(0, 1, 2, 3))
            return (s / occ.sum().clamp_min(1))[None, None, None, None]
        occ = self.occ[level_idx].to(x.dtype)
        s = (x * occ).sum(dim=(1, 2, 3), keepdim=True)
        return s / occ.sum(dim=(1, 2, 3), keepdim=True).clamp_min(1)


class SE(nn.Module):
    """A squeeze-excitation gate's two linear layers over C channels,
    reduced to max(C // reduction, 1)."""

    def __init__(self, c: int, reduction: int):
        super().__init__()
        r = max(c // reduction, 1)
        self.fc1 = nn.Linear(c, r)
        self.fc2 = nn.Linear(r, c)


class _Backbone(nn.Module):
    """What the Res16UNet and ResUNet families share: the execution
    contexts, the residual blocks (basic or bottleneck, with or without
    the squeeze-excitation gate), the stages and the parameters, named
    after the JAX package's. `BLOCK`, `EXPANSION` and `SE` are set by the
    variant."""

    PLANES: Sequence[int] = ()
    LAYERS: Sequence[int] = ()
    INIT_DIM: int = 32
    BLOCK: str = "basic"  # "basic" | "bottleneck"
    EXPANSION: int = 1  # 4 for the bottleneck variants
    SE: bool = False
    SE_REDUCTION: int = 16

    def __init__(self, in_channels: int, conv1_kernel_size: int, impl: str,
                 compute_dtype=None, int8_stride1: bool = False,
                 int8_residual: bool = False, int8_act_sigma: float = 0.0,
                 pallas_chain: bool = False, unit_features: bool = False,
                 brick_dims=(16, 16, 8), brick_capacity: int = 8192,
                 sp_axis=None, fold_small_stages: bool = False):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"backbone impl {impl!r} is not one of {IMPLS}")
        if impl != "dense" and (int8_stride1 or pallas_chain):
            raise NotImplementedError(
                "the int8 stack (int8_stride1, pallas_chain) runs on the "
                "dense impl only (the JAX package's bricked impl runs no "
                "int8 either)")
        if impl in ("gather", "gather_pallas") and unit_features:
            raise NotImplementedError(
                "unit_features is ported on the dense and bricked impls")
        self.sp_axis = sp_axis
        self.in_channels = in_channels
        self.conv1_kernel_size = conv1_kernel_size
        self.impl = impl
        self.compute_dtype = compute_dtype
        self.int8_stride1 = int8_stride1
        self.int8_residual = int8_residual
        self.int8_act_sigma = float(int8_act_sigma)
        self.pallas_chain = pallas_chain
        self.unit_features = unit_features
        self.fold_small_stages = fold_small_stages
        self.brick_dims = tuple(int(d) for d in brick_dims)
        self.brick_capacity = int(brick_capacity)
        self.convs = nn.ModuleDict()
        self.norms = nn.ModuleDict()
        self.se = nn.ModuleDict()

    def _conv(self, name, k, cin, cout, transpose=False, bias=False):
        self.convs[name] = Conv(k, cin, cout, transpose, bias)

    def _stage(self, stage, cin, planes, n):
        """The parameters of a stage of n blocks: basic (3^3, 3^3) or
        bottleneck (1x1 reduce, 3^3, 1x1 expand to planes * EXPANSION), a
        1x1 downsample of the residual where the width changes, and the
        squeeze-excitation gate with `SE`."""
        e = self.EXPANSION
        for i in range(n):
            name = f"block{stage}_{i}"
            ci = cin if i == 0 else planes * e
            if self.BLOCK == "bottleneck":
                self._conv(f"{name}_conv1", 1, ci, planes)
                self._conv(f"{name}_conv2", 3, planes, planes)
                self._conv(f"{name}_conv3", 1, planes, planes * e)
                self.norms[f"{name}_norm3"] = Norm(planes * e)
            else:
                self._conv(f"{name}_conv1", 3, ci, planes)
                self._conv(f"{name}_conv2", 3, planes, planes)
            self.norms[f"{name}_norm1"] = Norm(planes)
            self.norms[f"{name}_norm2"] = Norm(planes)
            if self.SE:
                self.se[name] = SE(planes * e, self.SE_REDUCTION)
            if ci != planes * e:
                self._conv(f"{name}_downsample", 1, ci, planes * e)
                self.norms[f"{name}_downsample_norm"] = Norm(planes * e)

    def init_weights(self, generator: torch.Generator):
        """He-normal conv kernels and gate weights (the JAX package's
        fan-in variance scaling), zero conv and gate biases, unit gamma,
        zero beta."""
        with torch.no_grad():
            for conv in self.convs.values():
                conv.weight.normal_(0.0, math.sqrt(2.0 / conv.fan_in),
                                    generator=generator)
                if conv.bias is not None:
                    conv.bias.zero_()
            for se in self.se.values():
                for fc in (se.fc1, se.fc2):
                    fc.weight.normal_(0.0, math.sqrt(2.0 / fc.in_features),
                                      generator=generator)
                    fc.bias.zero_()
            for norm in self.norms.values():
                norm.weight.fill_(1.0)
                norm.bias.zero_()

    def _context(self, feats, sb: SparseBatch, grid_dims, int8: bool,
                 chunks=None):
        """(execution context, level-0 input) of one forward."""
        if grid_dims is None and self.impl in ("dense", "bricked"):
            raise ValueError(f"backbone_impl={self.impl} needs the batch's "
                             f"static grid dims")
        plan = (slab_plan(grid_dims, self.sp_axis) if self.impl == "dense"
                else None)
        unit = self.unit_features and self.in_channels == 1
        int8_opts = dict(int8_stride1=self.int8_stride1 and int8,
                         int8_act_sigma=self.int8_act_sigma,
                         int8_residual=self.int8_residual)
        if plan is not None:
            ctx = _SlabCtx(sb, grid_dims, plan, sp_group(self.sp_axis),
                           self.compute_dtype, chunks, **int8_opts)
            return ctx, (ctx.occ[0].to(feats.dtype) if unit
                         else ctx.scatter(feats, 0))
        if self.impl == "dense":
            ctx = _DenseCtx(sb, grid_dims, self.compute_dtype, **int8_opts)
            # the scatter of unit features is the occupancy grid
            return ctx, (ctx.occ[0].to(feats.dtype) if unit
                         else ctx.scatter(feats, 0))
        if self.impl == "bricked":
            ctx = _BrickCtx(sb, grid_dims, self.compute_dtype,
                            self.brick_dims, self.brick_capacity)
            return ctx, (ctx.occ_b.to(feats.dtype) if unit
                         else ctx.scatter(feats, 0))
        ctx = _GatherCtx(sb, use_kernel=self.impl == "gather_pallas",
                         compute_dtype=self.compute_dtype)
        return ctx, ctx.scatter(feats, 0)

    # from mask3d_tpu/models/backbone.py:498 _act_bound
    def _act_bound(self, ctx, norm: Norm):
        """Static per-channel bound sigma*|gamma| + |beta| on the output of
        a norm (+ relu), for int8 activation scales; None unless this
        forward's context runs the int8 stack with `int8_act_sigma` > 0."""
        s = self.int8_act_sigma
        if s <= 0 or not getattr(ctx, "int8_l0", False):
            return None
        return act_bound(s, norm.weight, norm.bias)

    @staticmethod
    def _cat_bound(a, b):
        return None if a is None or b is None else torch.cat([a, b])

    # from mask3d_tpu/models/backbone.py:525 _se
    def _se(self, ctx, name, x, level_idx):
        """Squeeze-excitation: the item's mean over its occupied cells ->
        fc1 -> relu -> fc2 -> sigmoid, a per-channel gate in (0, 1) that
        multiplies x (empty cells stay 0)."""
        se = self.se[name]
        y = ctx.global_mean(x, level_idx).float()
        y = torch.sigmoid(se.fc2(torch.relu(se.fc1(y))))
        return x * y.to(x.dtype)

    def _join(self, ctx, name, x, out, level_idx, bin_, bout, want_q):
        """A block's tail: the gate (`SE`), the residual (1x1 conv + norm
        where the width changes) and relu(out + residual)."""
        if self.SE:
            # a sigmoid gate in (0, 1): the bound stays a bound
            out = self._se(ctx, name, out, level_idx)
        residual = x
        if f"{name}_downsample" in self.convs:
            nd = self.norms[f"{name}_downsample_norm"]
            residual = ctx.conv1x1(x, self.convs[f"{name}_downsample"],
                                   level_idx, bound=bin_)
            residual = ctx.norm(residual, nd, level_idx)
            bres = self._act_bound(ctx, nd)
        else:
            bres = bin_
        bout = None if bout is None or bres is None else bout + bres
        return ctx.block_join(out, residual, level_idx, bound=bout,
                              want_q=want_q), bout

    # from mask3d_tpu/models/backbone.py:539 _block
    def _block(self, ctx, name, x, level_idx, bin_=None, want_q=False):
        """BasicBlock: conv-norm-relu-conv-norm, the gate, the residual,
        relu of the sum. `bin_` is the static bound on |x|; returns (out,
        bound of out). `want_q`: the output may come back as a QGrid
        (`int8_residual`)."""
        n1, n2 = self.norms[f"{name}_norm1"], self.norms[f"{name}_norm2"]
        out = ctx.conv3(x, self.convs[f"{name}_conv1"], level_idx,
                        bound=bin_)
        out = torch.relu(ctx.norm(out, n1, level_idx))
        out = ctx.conv3(out, self.convs[f"{name}_conv2"], level_idx,
                        bound=self._act_bound(ctx, n1))
        out = ctx.norm(out, n2, level_idx)
        return self._join(ctx, name, x, out, level_idx, bin_,
                          self._act_bound(ctx, n2), want_q)

    # from mask3d_tpu/models/backbone.py:576 _block_bottleneck
    def _block_bottleneck(self, ctx, name, x, level_idx, bin_=None,
                          want_q=False):
        """Bottleneck block: 1x1 reduce -> norm -> relu -> 3^3 -> norm ->
        relu -> 1x1 expand (x EXPANSION) -> norm, then `_join`."""
        n1, n2, n3 = (self.norms[f"{name}_norm{i}"] for i in (1, 2, 3))
        out = ctx.conv1x1(x, self.convs[f"{name}_conv1"], level_idx,
                          bound=bin_)
        out = torch.relu(ctx.norm(out, n1, level_idx))
        out = ctx.conv3(out, self.convs[f"{name}_conv2"], level_idx,
                        bound=self._act_bound(ctx, n1))
        out = torch.relu(ctx.norm(out, n2, level_idx))
        out = ctx.conv1x1(out, self.convs[f"{name}_conv3"], level_idx,
                          bound=self._act_bound(ctx, n2))
        out = ctx.norm(out, n3, level_idx)
        return self._join(ctx, name, x, out, level_idx, bin_,
                          self._act_bound(ctx, n3), want_q)

    def _stage_widths(self, stage):
        """(cin, planes) of a stage, from its first block's conv1."""
        planes, cin = self.convs[f"block{stage}_0_conv1"].weight.shape[:2]
        return cin, planes

    def _stage_params(self, stage, keys):
        """Per block of the stage: {w<key>: weight, g<key>, b<key>: norm
        affine} for each (key, conv, norm) of `keys` the block has."""
        blocks = []
        for i in range(self.LAYERS[stage - 1]):
            name = f"block{stage}_{i}"
            blk = {}
            for key, conv, norm in keys:
                if f"{name}_{conv}" in self.convs:
                    nrm = self.norms[f"{name}_{norm}"]
                    blk[f"w{key}"] = self.convs[f"{name}_{conv}"].weight
                    blk[f"g{key}"], blk[f"b{key}"] = nrm.weight, nrm.bias
            blocks.append(blk)
        return blocks

    # from mask3d_tpu/models/backbone.py:617 _blocks_fused
    def _blocks_fused(self, ctx, stage, x, level_idx, bin_):
        """The whole stage through the fused int8 chain; the same
        parameters as `_block`."""
        blocks = self._stage_params(stage, (("1", "conv1", "norm1"),
                                            ("2", "conv2", "norm2"),
                                            ("d", "downsample",
                                             "downsample_norm")))
        for blk in blocks:
            for key in [k for k in blk if k[0] == "w"]:
                blk[key] = weight_rows(blk[key])
        y, bout = chain.fused_basic_stage(x, bin_, ctx.occ[level_idx],
                                          blocks, self.int8_act_sigma)
        # the chain emits bf16; downstream ops take the compute dtype
        return y.to(self.compute_dtype or torch.float32), bout

    # from mask3d_tpu/models/backbone.py:673-701 fold_small_stages (the
    # z-folded branch of _blocks)
    def _blocks_folded(self, ctx, stage, x, level_idx, bin_):
        """The whole stage in the z-folded layout
        (`dense_ops.dense_basic_stage_folded`); the same parameters as
        `_block`, so a checkpoint runs either way."""
        blocks = self._stage_params(stage, (("1", "conv1", "norm1"),
                                            ("2", "conv2", "norm2")))
        y = dense_ops.dense_basic_stage_folded(
            x, ctx.occ[level_idx], blocks, compute_dtype=self.compute_dtype)
        bnd = bin_
        for i in range(len(blocks)):
            b2 = self._act_bound(ctx, self.norms[f"block{stage}_{i}_norm2"])
            bnd = None if bnd is None or b2 is None else b2 + bnd
        return y, bnd

    # from mask3d_tpu/models/backbone.py:650 _blocks
    def _blocks(self, ctx, stage, x, level_idx, bin_=None):
        cin, planes = self._stage_widths(stage)
        basic = self.BLOCK == "basic" and not self.SE
        # a bound exists only on the dense int8 path with static scales
        if (self.pallas_chain and basic and bin_ is not None
                and self.sp_axis is None and not isinstance(x, QGrid)
                and min(cin, planes) >= 96 and cin <= 128
                and planes < 128  # the TPU layout's spare occupancy lane
                and chain.padded_rows(ctx.grid_dims[level_idx])
                >= chain.MIN_ROWS):
            return self._blocks_fused(ctx, stage, x, level_idx, bin_)
        if (self.fold_small_stages and self.impl == "dense" and basic
                and cin == planes <= 32 and self.sp_axis is None
                and not isinstance(x, QGrid)):
            return self._blocks_folded(ctx, stage, x, level_idx, bin_)
        block = (self._block_bottleneck if self.BLOCK == "bottleneck"
                 else self._block)
        # int8_residual: intermediate block outputs (read only by the next
        # block) may live as int8 QGrids; the stage output stays a grid
        wq = getattr(ctx, "int8_res", False) and \
            planes * self.EXPANSION >= 96
        n = self.LAYERS[stage - 1]
        for i in range(n):
            x, bin_ = block(ctx, f"block{stage}_{i}", x, level_idx,
                            bin_=bin_, want_q=wq and i < n - 1)
        return x, bin_


# from mask3d_tpu/models/backbone.py:447 Res16UNetBase
class Res16UNetBase(_Backbone):
    PLANES: Sequence[int] = (32, 64, 128, 256, 256, 256, 256, 256)
    LAYERS: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2)

    def __init__(self, in_channels: int = 1, conv1_kernel_size: int = 5,
                 impl: str = "dense", compute_dtype=None, **opts):
        """`opts`: the int8 knobs, `unit_features`, the brick shape and
        capacity, `sp_axis` and `fold_small_stages` (`_Backbone`)."""
        super().__init__(in_channels, conv1_kernel_size, impl,
                         compute_dtype, **opts)
        p, lay, c0, e = self.PLANES, self.LAYERS, self.INIT_DIM, \
            self.EXPANSION
        self._conv("conv0p1s1", conv1_kernel_size, in_channels, c0)
        self.norms["bn0"] = Norm(c0)
        # input width of each encoder level's down conv and first block
        enc_in = [c0, p[0] * e, p[1] * e, p[2] * e]
        for i in range(4):
            name = f"conv{i + 1}p{2 ** i}s2"
            self._conv(name, 2, enc_in[i], enc_in[i])
            self.norms[name.replace("conv", "bn")] = Norm(enc_in[i])
            self._stage(i + 1, enc_in[i], p[i], lay[i])
        # decoder: convtr{4..7}, stages 5..8 with skip concatenations
        dec_in = [p[3] * e, p[4] * e, p[5] * e, p[6] * e]
        skips = [p[2] * e, p[1] * e, p[0] * e, c0]
        for i in range(4):
            name = f"convtr{i + 4}p{2 ** (4 - i)}s2"
            self._conv(name, 2, dec_in[i], p[4 + i], transpose=True)
            self.norms[name.replace("convtr", "bntr")] = Norm(p[4 + i])
            self._stage(i + 5, p[4 + i] + skips[i], p[4 + i], lay[4 + i])

    # from mask3d_tpu/models/backbone.py:725 __call__ of Res16UNetBase
    def forward(self, feats, sb: SparseBatch, grid_dims, int8: bool = True,
                chunks=None) -> Tuple[torch.Tensor, List[torch.Tensor],
                                      Optional[torch.Tensor]]:
        """`int8=False` runs the fp32/bf16 convs whatever `int8_stride1`
        says: the model's train mode (the JAX package builds its backbone
        with `int8_stride1 and is_eval`, mask3d.py:406). `grid_dims` None
        (a batch without static grid dims) runs on the gather impls only.
        `chunks` (`parallel.mesh.RowChunks`, inference under sp): the
        sharded `dense` backbone returns this rank's chunk of each level's
        rows; the other impls return whole rows."""
        ctx, x = self._context(feats, sb, grid_dims, int8, chunks)

        # Encoder. The stem is conv -> norm -> relu (the JAX package's
        # dense impl runs the same arithmetic as a fused z-folded conv).
        out = ctx.conv_in(x, self.convs["conv0p1s1"])
        out_p1 = torch.relu(ctx.norm(out, self.norms["bn0"], 0))
        b_p1 = self._act_bound(ctx, self.norms["bn0"])

        def down(name, x_in, fine_idx):
            norm = self.norms[name.replace("conv", "bn")]
            out = ctx.conv_down(x_in, self.convs[name], fine_idx)
            return (torch.relu(ctx.norm(out, norm, fine_idx + 1)),
                    self._act_bound(ctx, norm))

        skips: Dict[int, torch.Tensor] = {0: out_p1}
        skip_bounds = {0: b_p1}
        out = out_p1
        for i in range(4):
            out, bnd = down(f"conv{i + 1}p{2 ** i}s2", out, i)
            out, bnd = self._blocks(ctx, i + 1, out, i + 1, bnd)
            skips[i + 1], skip_bounds[i + 1] = out, bnd

        feature_maps = [ctx.rows(out, 4)]  # stride 16

        # Decoder
        for i in range(4):
            coarse = 4 - i
            name = f"convtr{i + 4}p{2 ** coarse}s2"
            norm = self.norms[name.replace("convtr", "bntr")]
            out = ctx.conv_tr(out, self.convs[name], coarse)
            out = torch.relu(ctx.norm(out, norm, coarse - 1))
            bnd = self._cat_bound(self._act_bound(ctx, norm),
                                  skip_bounds[coarse - 1])
            out = torch.cat([out, skips[coarse - 1]], dim=-1)
            out, _ = self._blocks(ctx, i + 5, out, coarse - 1, bnd)
            feature_maps.append(ctx.rows(out, coarse - 1))
        return feature_maps[-1], feature_maps, (
            out if self.impl == "dense" else None)


class Res16UNet14(Res16UNetBase):
    LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)


class Res16UNet18(Res16UNetBase):
    LAYERS = (2, 2, 2, 2, 2, 2, 2, 2)


class Res16UNet34(Res16UNetBase):
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)


# from mask3d_tpu/models/backbone.py:932 Res16UNet50
class Res16UNet50(Res16UNetBase):
    """The bottleneck variant: every feature map is PLANES x 4 wide."""

    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
    BLOCK = "bottleneck"
    EXPANSION = 4


class Res16UNet101(Res16UNet50):
    LAYERS = (2, 3, 4, 23, 2, 2, 2, 2)


# from mask3d_tpu/models/backbone.py:856-929 Res16UNet14 .. (the basic-block
# variants: name -> (base, PLANES, LAYERS or None for the base's))
_VARIANTS = {
    "Res16UNet34A": (Res16UNet34, (32, 64, 128, 256, 256, 128, 64, 64), None),
    "Res16UNet34B": (Res16UNet34, (32, 64, 128, 256, 256, 128, 64, 32), None),
    "Res16UNet34C": (Res16UNet34, (32, 64, 128, 256, 256, 128, 96, 96), None),
    "Res16UNet34D": (Res16UNet34, (32, 64, 128, 256, 256, 128, 96, 128),
                     None),
    "Res16UNet14A": (Res16UNet14, (32, 64, 128, 256, 128, 128, 96, 96), None),
    "Res16UNet14A2": (Res16UNet14, (32, 64, 128, 256, 128, 128, 96, 96),
                      (1, 1, 1, 1, 2, 2, 2, 2)),
    "Res16UNet14B": (Res16UNet14, (32, 64, 128, 256, 128, 128, 128, 128),
                     None),
    "Res16UNet14B2": (Res16UNet14, (32, 64, 128, 256, 128, 128, 128, 128),
                      (1, 1, 1, 1, 2, 2, 2, 2)),
    "Res16UNet14B3": (Res16UNet14, (32, 64, 128, 256, 128, 128, 128, 128),
                      (2, 2, 2, 2, 1, 1, 1, 1)),
    "Res16UNet14C": (Res16UNet14, (32, 64, 128, 256, 192, 192, 128, 128),
                     None),
    "Res16UNet14D": (Res16UNet14, (32, 64, 128, 256, 384, 384, 384, 384),
                     None),
    "Res16UNet18A": (Res16UNet18, (32, 64, 128, 256, 128, 128, 96, 96), None),
    "Res16UNet18B": (Res16UNet18, (32, 64, 128, 256, 128, 128, 128, 128),
                     None),
    "Res16UNet18D": (Res16UNet18, (32, 64, 128, 256, 384, 384, 384, 384),
                     None),
    "Custom30M": (Res16UNet34, (32, 64, 128, 256, 128, 64, 64, 32), None),
}

BACKBONES = {"Res16UNet14": Res16UNet14, "Res16UNet18": Res16UNet18,
             "Res16UNet34": Res16UNet34, "Res16UNet50": Res16UNet50,
             "Res16UNet101": Res16UNet101}
for _name, (_base, _planes, _layers) in _VARIANTS.items():
    BACKBONES[_name] = type(_name, (_base,), dict(
        PLANES=_planes, LAYERS=_layers or _base.LAYERS))
