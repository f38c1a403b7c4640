"""k nearest neighbours, ball query, grouping and 3-NN interpolation over
padded point sets: batched dense distance computations, plain PyTorch as
the JAX package's are plain XLA (the pointnet2 / pointops2 ops of the
reference)."""

from __future__ import annotations

import torch


# from mask3d_tpu/ops/knn.py:20 pairwise_sqdist
def pairwise_sqdist(a, b):
    """[B, N, 3], [B, M, 3] -> [B, N, M] squared distances (one matmul)."""
    a2 = (a * a).sum(dim=-1)[..., :, None]
    b2 = (b * b).sum(dim=-1)[..., None, :]
    ab = torch.einsum("bnd,bmd->bnm", a, b)
    return (a2 + b2 - 2.0 * ab).clamp_min(0.0)


# from mask3d_tpu/ops/knn.py:29 knn
def knn(query, points, points_valid, k: int):
    """The k nearest valid points of each query: (idx i32[B, Q, k], dist
    f32[B, Q, k]) nearest first, ties to the lower index; an invalid point
    is at +inf (mask by `dist < inf` where fewer than k are valid)."""
    d = pairwise_sqdist(query, points)
    d = torch.where(points_valid[:, None, :], d, float("inf"))
    dist, idx = torch.sort(d, dim=-1, stable=True)
    return idx[..., :k].to(torch.int32), dist[..., :k]


# from mask3d_tpu/ops/knn.py:41 ball_query
def ball_query(query, points, points_valid, radius: float, k: int):
    """Up to k points within `radius` of each query, the first ones found
    in point order, the empty slots filled with the first (pointnet2's
    ball query): (idx i32[B, Q, k], ok bool[B, Q, k]); a query with no
    neighbour gets idx 0 and ok False."""
    d = pairwise_sqdist(query, points)
    inside = (d <= radius * radius) & points_valid[:, None, :]
    n = points.shape[1]
    rank = torch.where(inside, 0, 1) * (n + 1) + torch.arange(
        n, device=points.device)[None, None, :]
    order = torch.argsort(rank, dim=-1)[..., :k]
    ok = torch.gather(inside, -1, order)
    idx = torch.where(ok, order, order[..., :1])
    any_ok = ok[..., :1]
    return torch.where(any_ok, idx, 0).to(torch.int32), ok & any_ok


# from mask3d_tpu/ops/knn.py:59 group_points
def group_points(feats, idx):
    """feats [B, N, C], idx [B, Q, k] -> [B, Q, k, C]."""
    b, q, k = idx.shape
    flat = idx.reshape(b, q * k).long()
    out = torch.gather(feats, 1, flat[..., None].expand(-1, -1,
                                                        feats.shape[-1]))
    return out.reshape(b, q, k, feats.shape[-1])


# from mask3d_tpu/ops/knn.py:68 three_interpolate
def three_interpolate(unknown, known, known_valid, feats):
    """Inverse-distance-weighted mean of the 3 nearest known points'
    features: unknown [B, U, 3], known [B, M, 3], feats [B, M, C] ->
    [B, U, C]."""
    idx, d = knn(unknown, known, known_valid, 3)
    w = 1.0 / d.clamp_min(1e-8)
    w = torch.where(torch.isfinite(w), w, 0.0)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-8)
    return (group_points(feats, idx) * w[..., None]).sum(dim=2)
