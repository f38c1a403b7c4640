"""Furthest-point sampling as a batched max-min loop.

pointnet2 semantics: the first centroid is point 0, then iteratively the
point with the largest min-distance to the selected set. Padded points carry
the sentinel -1 and are never selected while a valid point remains; ties go
to the first maximum (`torch.argmax`), as in JAX.
"""

from __future__ import annotations

import torch


# from mask3d_tpu/ops/fps.py:25 furthest_point_sample
def furthest_point_sample(coords, valid, num_samples: int):
    """coords: f32[B, N, 3]; valid: bool[B, N] -> i64[B, Q]."""
    c = coords.float()
    b = c.shape[0]
    neg = torch.tensor(-1.0, device=c.device)
    min_dist = torch.where(valid, torch.tensor(1e10, device=c.device), neg)
    idxs = torch.zeros((b, num_samples), dtype=torch.long, device=c.device)
    bi = torch.arange(b, device=c.device)
    for i in range(num_samples):
        if i > 0:
            idxs[:, i] = torch.argmax(min_dist, dim=1)
        far = c[bi, idxs[:, i]]  # [B, 3]
        d = ((c - far[:, None, :]) ** 2).sum(dim=-1)
        min_dist = torch.where(valid, torch.minimum(min_dist, d), neg)
    return idxs
