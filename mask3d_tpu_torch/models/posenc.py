"""Positional encodings of 3D coordinates (Fourier features and sine).

Batched over items with per-item normalization ranges; returns [B, P, D]
(channel-last).
"""

from __future__ import annotations

import math

import torch


# from mask3d_tpu/models/posenc.py:21 shift_scale_points
def shift_scale_points(xyz, mins, maxs):
    """Normalize per-item coordinates to [0, 1]^3 (xyz [B, P, 3],
    mins/maxs [B, 3])."""
    rng = maxs - mins
    rng = torch.where(rng == 0, torch.ones_like(rng), rng)
    return (xyz - mins[:, None, :]) / rng[:, None, :]


# from mask3d_tpu/models/posenc.py:32 fourier_embeddings
def fourier_embeddings(xyz, gauss_b, mins=None, maxs=None, normalize=True):
    """Random Fourier features sin/cos of (2*pi*xyz) @ B; gauss_b is
    [3, D/2]. Returns [B, P, D]."""
    x = xyz.float()
    if normalize:
        x = shift_scale_points(x, mins, maxs)
    x = x * (2.0 * math.pi)
    proj = torch.einsum("bpi,id->bpd", x, gauss_b.float())
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


# from mask3d_tpu/models/posenc.py:46 sine_embeddings
def sine_embeddings(xyz, d_pos, mins=None, maxs=None, normalize=True,
                    temperature=10000.0, scale=2.0 * math.pi):
    """Interleaved sin/cos encodings per coordinate axis; `d_pos` split
    across the three axes, remainder to the leading axes in steps of two."""
    x = xyz.float()
    if normalize:
        x = shift_scale_points(x, mins, maxs)

    ndim = d_pos // 3
    if ndim % 2 != 0:
        ndim -= 1
    rems = d_pos - ndim * 3

    outs = []
    for d in range(3):
        cdim = ndim
        if rems > 0:
            cdim += 2
            rems -= 2
        dim_t = torch.arange(cdim, dtype=torch.float32, device=x.device)
        dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / cdim)
        pos = (x[..., d] * scale)[..., None] / dim_t  # [B, P, cdim]
        sin = torch.sin(pos[..., 0::2])
        cos = torch.cos(pos[..., 1::2])
        outs.append(torch.stack([sin, cos], dim=-1).reshape(
            *pos.shape[:-1], cdim))
    return torch.cat(outs, dim=-1)
