"""Res16UNet sparse-voxel backbones (fp32, with bf16 gather convs on
`gather_pallas`).

A 4-stage stride-2 encoder and a 4-stage transposed-conv decoder with skip
concatenations and InstanceNorm everywhere. Three executions share one
parameter layout (`impl`, the JAX package's `backbone_impl`):

- `dense`: dense convolutions re-masked by occupancy on per-level grids
  (`sparse/dense_ops.py`);
- `gather`: row-space gather-matmul convolutions over kernel maps and
  stride-2 convs over PoolMaps (`sparse/ops.py`), fp32;
- `gather_pallas`: `gather` whose same-stride convs run the bf16 sparse-conv
  kernel (`sparse/sparse_conv.py`) on every level that `supports()` its
  capacity.

Returns `(out_rows, feature_maps, out_grid)`: stride-1 rows [B, N, PLANES[7]],
the five pyramid outputs as rows at strides [16, 8, 4, 2, 1], and the final
level-0 grid for the pooled pyramid (None on the gather impls).

Parameters are named after the JAX package's (`conv0p1s1`, `bn0`,
`block1_0_conv1`, `block1_0_norm1`, ...): `convs[name].weight` holds the
kernel in PyTorch's layout and `norms[name]` the InstanceNorm gamma/beta.
Only basic-block variants without squeeze-excitation are ported.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from mask3d_tpu_torch.sparse import dense_ops, ops
from mask3d_tpu_torch.sparse import sparse_conv as sc
from mask3d_tpu_torch.sparse.context import SparseBatch

IMPLS = ("dense", "gather", "gather_pallas")


class Conv(nn.Module):
    """A bias-free conv weight: [Cout, Cin, k, k, k], or [Cin, Cout, 2, 2, 2]
    for a transposed conv."""

    def __init__(self, k: int, cin: int, cout: int, transpose=False):
        super().__init__()
        shape = (cin, cout) if transpose else (cout, cin)
        self.weight = nn.Parameter(torch.empty(shape + (k, k, k)))
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
    w = conv.weight
    return w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[1], w.shape[0])


def _kernel_rows_tr(conv: Conv):
    """A transposed weight [Cin, Cout, 2, 2, 2] as [8, Cin, Cout] by child
    position (x&1)*4 + (y&1)*2 + (z&1)."""
    w = conv.weight
    return w.permute(2, 3, 4, 0, 1).reshape(8, w.shape[0], w.shape[1])


# from mask3d_tpu/models/backbone.py:54 _GatherCtx (fp32; bf16 sparse-conv
# kernel on eligible levels with use_kernel)
class _GatherCtx:
    """Row-form execution over kernel maps: features stay [B, N, C] rows of
    their level. With `use_kernel`, same-stride convs on levels whose
    capacity `supports()` run the bf16 sparse-conv kernel; the others run
    the fp32 gather-matmul."""

    def __init__(self, sb: SparseBatch, use_kernel: bool):
        self.sb = sb
        self.use_kernel = use_kernel

    def scatter(self, feats_rows, level_idx):
        return feats_rows  # rows are already per-level

    def _conv(self, x, conv: Conv, idx, ok):
        w = _kernel_rows(conv)
        if self.use_kernel and sc.supports(x.shape[1]):
            return sc.sparse_conv(x, w, idx, ok)
        return ops.sparse_conv(x, w, idx, ok)

    def conv_in(self, x, conv: Conv):
        return self._conv(x, conv, self.sb.nbr0_idx, self.sb.nbr0_ok)

    def conv3(self, x, conv: Conv, level_idx):
        return self._conv(x, conv, self.sb.nbr_idx[level_idx],
                          self.sb.nbr_ok[level_idx])

    def conv1x1(self, x, conv: Conv, level_idx):
        w = conv.weight
        return x @ w.reshape(w.shape[0], w.shape[1]).t()

    def conv_down(self, x, conv: Conv, fine_idx):
        return ops.sparse_conv_down(x, _kernel_rows(conv),
                                    self.sb.pools[fine_idx],
                                    self.sb.levels[fine_idx + 1].capacity)

    def conv_tr(self, x, conv: Conv, coarse_idx):
        return ops.sparse_conv_tr(x, _kernel_rows_tr(conv),
                                  self.sb.pools[coarse_idx - 1],
                                  self.sb.levels[coarse_idx - 1].valid)

    def norm(self, x, norm: Norm, level_idx):
        return ops.instance_norm(x, self.sb.levels[level_idx].valid,
                                 norm.weight, norm.bias)

    def rows(self, x, level_idx):
        return x


# from mask3d_tpu/models/backbone.py:150 _DenseCtx (fp32; no int8, no sp)
class _DenseCtx:
    """Dense-grid execution: features live as [B, Gx, Gy, Gz, C] per level."""

    def __init__(self, sb: SparseBatch, grid_dims):
        self.sb = sb
        self.grid_dims = list(grid_dims)
        self.occ = list(sb.occ)

    def scatter(self, feats_rows, level_idx):
        return dense_ops.scatter_rows(
            feats_rows, self.sb.levels[level_idx], self.grid_dims[level_idx])

    def conv3(self, x, conv: Conv, level_idx):
        return dense_ops.dense_conv_same(x, conv.weight, self.occ[level_idx])

    def conv_in(self, x, conv: Conv):
        return self.conv3(x, conv, 0)

    conv1x1 = conv3  # k=1 weights: the residual downsample

    def conv_down(self, x, conv: Conv, fine_idx):
        return dense_ops.dense_conv_down(x, conv.weight,
                                         self.occ[fine_idx + 1])

    def conv_tr(self, x, conv: Conv, coarse_idx):
        return dense_ops.dense_conv_tr(x, conv.weight,
                                       self.occ[coarse_idx - 1])

    def norm(self, x, norm: Norm, level_idx):
        return dense_ops.dense_instance_norm(x, self.occ[level_idx],
                                             norm.weight, norm.bias)

    def rows(self, x, level_idx):
        return dense_ops.gather_rows(x, self.sb.levels[level_idx],
                                     self.grid_dims[level_idx])


# from mask3d_tpu/models/backbone.py:447 Res16UNetBase
class Res16UNetBase(nn.Module):
    PLANES: Sequence[int] = (32, 64, 128, 256, 256, 256, 256, 256)
    LAYERS: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2)
    INIT_DIM: int = 32

    def __init__(self, in_channels: int = 1, conv1_kernel_size: int = 5,
                 impl: str = "dense"):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"backbone impl {impl!r} is not one of {IMPLS}")
        self.in_channels = in_channels
        self.conv1_kernel_size = conv1_kernel_size
        self.impl = impl
        self.convs = nn.ModuleDict()
        self.norms = nn.ModuleDict()
        p, lay, c0 = self.PLANES, self.LAYERS, self.INIT_DIM
        self._conv("conv0p1s1", conv1_kernel_size, in_channels, c0)
        self.norms["bn0"] = Norm(c0)
        # input width of each encoder level's down conv and first block
        enc_in = [c0, p[0], p[1], p[2]]
        for i in range(4):
            name = f"conv{i + 1}p{2 ** i}s2"
            self._conv(name, 2, enc_in[i], enc_in[i])
            self.norms[name.replace("conv", "bn")] = Norm(enc_in[i])
            self._stage(i + 1, enc_in[i], p[i], lay[i])
        # decoder: convtr{4..7}, stages 5..8 with skip concatenations
        dec_in = [p[3], p[4], p[5], p[6]]
        skips = [p[2], p[1], p[0], c0]
        for i in range(4):
            name = f"convtr{i + 4}p{2 ** (4 - i)}s2"
            self._conv(name, 2, dec_in[i], p[4 + i], transpose=True)
            self.norms[name.replace("convtr", "bntr")] = Norm(p[4 + i])
            self._stage(i + 5, p[4 + i] + skips[i], p[4 + i], lay[4 + i])

    def _conv(self, name, k, cin, cout, transpose=False):
        self.convs[name] = Conv(k, cin, cout, transpose)

    def _stage(self, stage, cin, planes, n):
        for i in range(n):
            name = f"block{stage}_{i}"
            ci = cin if i == 0 else planes
            self._conv(f"{name}_conv1", 3, ci, planes)
            self.norms[f"{name}_norm1"] = Norm(planes)
            self._conv(f"{name}_conv2", 3, planes, planes)
            self.norms[f"{name}_norm2"] = Norm(planes)
            if ci != planes:
                self._conv(f"{name}_downsample", 1, ci, planes)
                self.norms[f"{name}_downsample_norm"] = Norm(planes)

    def init_weights(self, generator: torch.Generator):
        """He-normal conv kernels (the JAX package's fan-in variance
        scaling), unit gamma, zero beta."""
        with torch.no_grad():
            for conv in self.convs.values():
                conv.weight.normal_(0.0, math.sqrt(2.0 / conv.fan_in),
                                    generator=generator)
            for norm in self.norms.values():
                norm.weight.fill_(1.0)
                norm.bias.zero_()

    # from mask3d_tpu/models/backbone.py:539 _block
    def _block(self, ctx, name, x, level_idx):
        """BasicBlock: conv-norm-relu-conv-norm, residual (1x1 conv + norm
        where the width changes), relu of the sum."""
        residual = x
        out = ctx.conv3(x, self.convs[f"{name}_conv1"], level_idx)
        out = torch.relu(ctx.norm(out, self.norms[f"{name}_norm1"],
                                  level_idx))
        out = ctx.conv3(out, self.convs[f"{name}_conv2"], level_idx)
        out = ctx.norm(out, self.norms[f"{name}_norm2"], level_idx)
        if f"{name}_downsample" in self.convs:
            residual = ctx.conv1x1(residual,
                                   self.convs[f"{name}_downsample"],
                                   level_idx)
            residual = ctx.norm(residual,
                                self.norms[f"{name}_downsample_norm"],
                                level_idx)
        return torch.relu(out + residual)

    # from mask3d_tpu/models/backbone.py:650 _blocks
    def _blocks(self, ctx, stage, x, level_idx):
        for i in range(self.LAYERS[stage - 1]):
            x = self._block(ctx, f"block{stage}_{i}", x, level_idx)
        return x

    # from mask3d_tpu/models/backbone.py:725 Res16UNetBase.__call__
    def forward(self, feats, sb: SparseBatch, grid_dims
                ) -> Tuple[torch.Tensor, List[torch.Tensor],
                           Optional[torch.Tensor]]:
        if self.impl == "dense":
            ctx = _DenseCtx(sb, grid_dims)
        else:
            ctx = _GatherCtx(sb, use_kernel=self.impl == "gather_pallas")
        x = ctx.scatter(feats, 0)

        # Encoder. The stem is conv -> norm -> relu (the JAX package's
        # dense impl runs the same arithmetic as a fused z-folded conv).
        out = ctx.conv_in(x, self.convs["conv0p1s1"])
        out_p1 = torch.relu(ctx.norm(out, self.norms["bn0"], 0))

        def down(name, x_in, fine_idx):
            out = ctx.conv_down(x_in, self.convs[name], fine_idx)
            return torch.relu(ctx.norm(out, self.norms[name.replace(
                "conv", "bn")], fine_idx + 1))

        skips: Dict[int, torch.Tensor] = {0: out_p1}
        out = out_p1
        for i in range(4):
            out = down(f"conv{i + 1}p{2 ** i}s2", out, i)
            out = self._blocks(ctx, i + 1, out, i + 1)
            skips[i + 1] = out

        feature_maps = [ctx.rows(out, 4)]  # stride 16

        # Decoder
        for i in range(4):
            coarse = 4 - i
            name = f"convtr{i + 4}p{2 ** coarse}s2"
            out = ctx.conv_tr(out, self.convs[name], coarse)
            out = torch.relu(ctx.norm(out, self.norms[name.replace(
                "convtr", "bntr")], coarse - 1))
            out = torch.cat([out, skips[coarse - 1]], dim=-1)
            out = self._blocks(ctx, i + 5, out, coarse - 1)
            feature_maps.append(ctx.rows(out, coarse - 1))
        return feature_maps[-1], feature_maps, (
            out if self.impl == "dense" else None)


class Res16UNet14(Res16UNetBase):
    LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)


class Res16UNet18(Res16UNetBase):
    LAYERS = (2, 2, 2, 2, 2, 2, 2, 2)


class Res16UNet34(Res16UNetBase):
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)


# from mask3d_tpu/models/backbone.py:856-929 (basic-block variants:
# name -> (base, PLANES, LAYERS or None for the base's))
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
             "Res16UNet34": Res16UNet34}
for _name, (_base, _planes, _layers) in _VARIANTS.items():
    BACKBONES[_name] = type(_name, (_base,), dict(
        PLANES=_planes, LAYERS=_layers or _base.LAYERS))
