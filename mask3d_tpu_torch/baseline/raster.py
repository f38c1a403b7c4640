"""Differentiable soft polygon rasterization in plain PyTorch (the JAX
package's `baseline/raster.py`, plain XLA there).

A polygon is rendered into a soft occupancy map by the signed distance of
each pixel centre to its boundary pushed through a sigmoid ("mask"), a
boundary ridge exp(-d^2/tau) ("boundary"), or binary containment
("hard_mask") (reference `diff_ras`, `RoomFormer/diff_ras/polygon.py:22-60`,
consumed by `MaskRasterizationLoss`, `RoomFormer/models/losses.py:100-160`).
Every polygon of a batch is rendered at once; gradients flow to the vertex
coordinates.
"""

from __future__ import annotations

import torch


def _pixel_centres(resolution: int, device) -> torch.Tensor:
    """[R*R, 2] (x, y) pixel centres, row-major over (y, x)."""
    c = torch.arange(resolution, dtype=torch.float32, device=device) + 0.5
    ys, xs = torch.meshgrid(c, c, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


# from mask3d_tpu/baseline/raster.py:19 _point_edge_distance
def _point_edge_distance(pix, poly, edge_valid):
    """Min distance from each pixel to the valid polygon edges.

    pix: [R*R, 2]; poly: [P, K, 2]; edge_valid: [P, K] (edge k = poly[k] ->
    poly[k+1 mod K]). Returns [P, R*R]. The min spreads its gradient
    evenly over tied edges, as `jnp.min` does.
    """
    p0 = poly
    p1 = torch.roll(poly, -1, dims=1)
    d = p1 - p0  # [P, K, 2]
    len2 = torch.clamp((d * d).sum(-1), min=1e-12)  # [P, K]
    diff = pix[None, :, None, :] - p0[:, None]  # [P, R*R, K, 2]
    t = torch.clamp((diff * d[:, None]).sum(-1) / len2[:, None], 0.0, 1.0)
    proj = p0[:, None] + t[..., None] * d[:, None]
    dist = torch.linalg.vector_norm(pix[None, :, None, :] - proj, dim=-1)
    dist = torch.where(edge_valid[:, None, :], dist,
                       torch.full_like(dist, float("inf")))
    return torch.amin(dist, dim=-1)


# from mask3d_tpu/baseline/raster.py:38 _point_in_polygon
def _point_in_polygon(pix, poly, edge_valid):
    """Crossing-number containment over the valid edges. [P, R*R] bool."""
    x0, y0 = poly[..., 0][:, None], poly[..., 1][:, None]  # [P, 1, K]
    x1 = torch.roll(x0, -1, dims=-1)
    y1 = torch.roll(y0, -1, dims=-1)
    px, py = pix[None, :, 0, None], pix[None, :, 1, None]  # [1, R*R, 1]
    straddle = (y0 > py) != (y1 > py)
    dy = torch.where(y1 - y0 == 0, torch.full_like(y0, 1e-12), y1 - y0)
    x_cross = x0 + (py - y0) * (x1 - x0) / dy
    hits = straddle & (px < x_cross) & edge_valid[:, None, :]
    return (hits.sum(-1) % 2) == 1


# from mask3d_tpu/baseline/raster.py:86 soft_polygon_batch
def soft_polygon_batch(polys: torch.Tensor, valids: torch.Tensor,
                       resolution: int, inv_smoothness: float = 0.1,
                       mode: str = "mask") -> torch.Tensor:
    """Render P polygons to soft [P, R, R] maps (`soft_polygon`, :50, over
    a batch).

    polys: [P, K, 2] vertex coords in PIXEL units of the target resolution;
    valids: bool [P, K] (padded vertices False: the last valid vertex
    connects back to the first). Modes: "mask" =
    sigmoid(signed_dist / inv_smoothness), "boundary" =
    exp(-d^2 / inv_smoothness), "hard_mask" = binary containment.
    """
    if mode not in ("mask", "boundary", "hard_mask"):
        raise ValueError(f"unknown raster mode {mode!r}")
    npoly, k = valids.shape
    n_valid = valids.to(torch.int64).sum(-1, keepdim=True)  # [P, 1]
    # Invalid vertices collapse onto vertex 0, so the edge from the last
    # valid vertex wraps to v0 through degenerate edges; those are skipped.
    poly = torch.where(valids[..., None], polys, polys[:, :1])
    edge_valid = torch.arange(k, device=polys.device)[None] < n_valid
    pix = _pixel_centres(resolution, polys.device)
    shape = (npoly, resolution, resolution)
    if mode == "hard_mask":
        return _point_in_polygon(pix, poly, edge_valid).to(
            torch.float32).reshape(shape)
    dist = _point_edge_distance(pix, poly, edge_valid)
    if mode == "boundary":
        return torch.exp(-(dist ** 2) / inv_smoothness).reshape(shape)
    inside = _point_in_polygon(pix, poly, edge_valid)
    signed = torch.where(inside, dist, -dist)
    return torch.sigmoid(signed / inv_smoothness).reshape(shape)


def soft_polygon(poly: torch.Tensor, valid: torch.Tensor, resolution: int,
                 inv_smoothness: float = 0.1, mode: str = "mask"
                 ) -> torch.Tensor:
    """One polygon [K, 2] -> [R, R] (`soft_polygon_batch` of one)."""
    return soft_polygon_batch(poly[None], valid[None], resolution,
                              inv_smoothness, mode)[0]
