"""Multi-scale deformable attention in plain PyTorch (the JAX package's
`baseline/deform_attn.py`, which is plain XLA there).

Each query samples a few bilinear points per head per feature level and
mixes them with learned attention weights (reference `MSDeformAttn`,
`RoomFormer/models/ops/modules/ms_deform_attn.py:30`, and its plain oracle
`ms_deform_attn_core_pytorch`). The sampler is a gather: the four taps of
every point are read from the flattened value map by `index_select`, whose
backward is a deterministic scatter-add on the card under
`torch.use_deterministic_algorithms(True)`; `F.grid_sample` computes the
same forward, but its CUDA backward has no deterministic implementation.
`ms_deform_attn_grid_sample` is that composition, kept as an independent
reference for the tests and `chip_smoke.py`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


# from mask3d_tpu/baseline/deform_attn.py:25 bilinear_sample
def bilinear_sample(value: torch.Tensor, loc_xy: torch.Tensor
                    ) -> torch.Tensor:
    """Bilinear sampling with zeros outside the map (`F.grid_sample` with
    `align_corners=False`: pixel centres at (i + 0.5) / size).

    value: [N, H, W, C]; loc_xy: [N, M, 2] normalized to [0, 1], x along
    the width. Returns [N, M, C].
    """
    n, h, w, c = value.shape
    flat = value.reshape(n * h * w, c)
    x = loc_xy[..., 0] * w - 0.5
    y = loc_xy[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    base = (torch.arange(n, device=value.device) * (h * w))[:, None]

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c)
        return v * inside[..., None].to(v.dtype)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return (v00 * (1 - dx) * (1 - dy) + v01 * dx * (1 - dy)
            + v10 * (1 - dx) * dy + v11 * dx * dy)


def _levels(value, spatial_shapes, sampling_locations):
    """Per level: the value map as [B*H, h, w, hd] and the level's sampling
    locations as [B*H, Q*P, 2]."""
    b, _, nh, hd = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    offset = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        val = value[:, offset:offset + h * w]
        offset += h * w
        val = val.reshape(b, h, w, nh, hd).permute(0, 3, 1, 2, 4)
        loc = sampling_locations[:, :, :, lvl].permute(0, 2, 1, 3, 4)
        yield (val.reshape(b * nh, h, w, hd),
               loc.reshape(b * nh, q * p, 2))


def _mix(sampled, attention_weights):
    """sampled: per level [B*H, Q*P, hd] -> [B, Q, H*hd] weighted by
    attention_weights [B, Q, H, L, P]."""
    b, q, nh, nl, p = attention_weights.shape
    hd = sampled[0].shape[-1]
    stacked = torch.stack(
        [s.reshape(b, nh, q, p, hd) for s in sampled], dim=3)
    wts = attention_weights.permute(0, 2, 1, 3, 4)  # [B, H, Q, L, P]
    out = (stacked * wts[..., None]).sum(dim=(3, 4))  # [B, H, Q, hd]
    return out.permute(0, 2, 1, 3).reshape(b, q, nh * hd)


# from mask3d_tpu/baseline/deform_attn.py:59 ms_deform_attn_core
def ms_deform_attn_core(value: torch.Tensor,
                        spatial_shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """value: [B, sum(H_l*W_l), H, hd]; sampling_locations:
    [B, Q, H, L, P, 2] in [0, 1]; attention_weights: [B, Q, H, L, P]
    (normalized over L*P). Returns [B, Q, H*hd]."""
    sampled = [bilinear_sample(val, loc) for val, loc in
               _levels(value, spatial_shapes, sampling_locations)]
    return _mix(sampled, attention_weights)


def ms_deform_attn_grid_sample(value: torch.Tensor,
                               spatial_shapes: Sequence[Tuple[int, int]],
                               sampling_locations: torch.Tensor,
                               attention_weights: torch.Tensor
                               ) -> torch.Tensor:
    """`ms_deform_attn_core` through `F.grid_sample` (zeros padding,
    `align_corners=False`), the reference's own oracle: an independent
    reference for the gather form (its CUDA backward is not
    deterministic)."""
    sampled = []
    for val, loc in _levels(value, spatial_shapes, sampling_locations):
        grid = (2.0 * loc - 1.0)[:, :, None, :]  # [B*H, Q*P, 1, 2]
        s = F.grid_sample(val.permute(0, 3, 1, 2), grid, mode="bilinear",
                          padding_mode="zeros", align_corners=False)
        sampled.append(s[..., 0].transpose(1, 2))  # [B*H, Q*P, hd]
    return _mix(sampled, attention_weights)
