"""A copy of mask3d_tpu/baseline/polygonize.py.

Mask -> polygon extraction for the floorplan evaluation protocol (R5).

Pure-numpy rebuild of the reference's cv2 pipeline
(`RoomFormer/s3d_floorplan_eval/Evaluator/Evaluator.py:25-60` and
`DataRW/S3DRW.py:79-115`):

    binary room mask
      -> outer contours of the 8-connected components (cv2.findContours,
         CHAIN_APPROX_NONE == full boundary pixel chains; here: Moore
         neighbor tracing)
      -> keep the largest-area contour (cv2.contourArea == shoelace)
      -> Douglas-Peucker with epsilon = degree * perimeter
         (cv2.approxPolyDP, closed)
      -> optionally re-rasterize the polygon (cv2.fillPoly)

No cv2 in this environment — the tracing, simplification and fill are
implemented directly and oracle-tested on rectilinear rooms whose true
polygons are known (tests/test_polygonize.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# clockwise 8-neighborhood in (dx, dy), screen coords (y down) — the Moore
# tracing scan order; starting the scan one step past the backtrack
# direction walks the outer boundary counterclockwise (in image coords),
# matching cv2's outer-contour orientation.
_NBR8 = np.array(
    [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)],
    np.int64,
)


# from mask3d_tpu/baseline/polygonize.py:37 trace_outer_contour
def trace_outer_contour(mask: np.ndarray,
                        start: Optional[Tuple[int, int]] = None
                        ) -> np.ndarray:
    """Full boundary pixel chain [K, 2] as (x, y) of one 8-connected
    component's outer border (Moore neighbor tracing with Jacob's stopping
    criterion). `start` is the component's topmost-leftmost pixel (found
    by raster scan when None). The chain visits every border pixel like
    cv2 CHAIN_APPROX_NONE."""
    m = np.asarray(mask).astype(bool)
    h, w = m.shape
    if start is None:
        idx = np.flatnonzero(m.ravel())
        if len(idx) == 0:
            return np.zeros((0, 2), np.int64)
        y0, x0 = divmod(int(idx[0]), w)
    else:
        x0, y0 = start

    def fg(x, y):
        return 0 <= x < w and 0 <= y < h and m[y, x]

    _dir_of = {(int(dx), int(dy)): i for i, (dx, dy) in enumerate(_NBR8)}

    # Backtrack PIXEL: the raster scan arrived from the left (background
    # by construction of the topmost-leftmost start).
    chain = [(x0, y0)]
    bx, by = x0 - 1, y0
    cx, cy = x0, y0
    first_next = None
    for _ in range(4 * h * w + 8):
        back = _dir_of[(bx - cx, by - cy)]
        found = False
        for k in range(1, 9):
            d = (back + k) % 8
            nx, ny = cx + int(_NBR8[d, 0]), cy + int(_NBR8[d, 1])
            if fg(nx, ny):
                # Jacob's criterion: stop on re-entering the start pixel
                # moving to the same next pixel as the first move.
                if (cx, cy) == (x0, y0) and len(chain) > 1:
                    if first_next == (nx, ny):
                        return np.asarray(chain[:-1], np.int64)
                if len(chain) == 1:
                    first_next = (nx, ny)
                # New backtrack: the last BACKGROUND neighbor scanned —
                # the one just before n in the clockwise sweep (== the old
                # backtrack itself when n is the first neighbor checked).
                dprev = (back + k - 1) % 8
                bx, by = cx + int(_NBR8[dprev, 0]), cy + int(_NBR8[dprev, 1])
                cx, cy = nx, ny
                chain.append((cx, cy))
                found = True
                break
        if not found:  # isolated pixel
            return np.asarray(chain[:1], np.int64)
    return np.asarray(chain, np.int64)  # safety: should never hit


# from mask3d_tpu/baseline/polygonize.py:94 contour_area
def contour_area(chain: np.ndarray) -> float:
    """Shoelace area of a closed pixel chain (== cv2.contourArea)."""
    if len(chain) < 3:
        return 0.0
    p = np.asarray(chain, np.float64)
    x, y = p[:, 0], p[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
                 / 2.0)


# from mask3d_tpu/baseline/polygonize.py:104 arc_length
def arc_length(chain: np.ndarray, closed: bool = True) -> float:
    """Perimeter of the chain (== cv2.arcLength)."""
    p = np.asarray(chain, np.float64)
    if len(p) < 2:
        return 0.0
    seg = np.diff(np.concatenate([p, p[:1]], 0) if closed else p, axis=0)
    return float(np.linalg.norm(seg, axis=1).sum())


# from mask3d_tpu/baseline/polygonize.py:113 _dp_open
def _dp_open(pts: np.ndarray, eps: float) -> List[int]:
    """Douglas-Peucker on an open chain; returns kept indices incl. ends."""
    n = len(pts)
    if n <= 2:
        return list(range(n))
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    p = pts.astype(np.float64)
    while stack:
        i, j = stack.pop()
        if j <= i + 1:
            continue
        a, b = p[i], p[j]
        ab = b - a
        L = np.hypot(*ab)
        seg = p[i + 1:j]
        if L < 1e-12:
            d = np.linalg.norm(seg - a, axis=1)
        else:
            rel = seg - a
            d = np.abs(ab[0] * rel[:, 1] - ab[1] * rel[:, 0]) / L
        k = int(np.argmax(d))
        if d[k] > eps:
            m = i + 1 + k
            keep[m] = True
            stack.append((i, m))
            stack.append((m, j))
    return list(np.flatnonzero(keep))


# from mask3d_tpu/baseline/polygonize.py:144 approx_poly_dp
def approx_poly_dp(chain: np.ndarray, eps: float) -> np.ndarray:
    """Closed-curve Douglas-Peucker (cv2.approxPolyDP(closed=True)):
    anchor at two far-apart points, simplify both halves."""
    pts = np.asarray(chain, np.float64)
    n = len(pts)
    if n <= 2:
        return np.asarray(chain, np.int64).reshape(-1, 2)
    i1 = int(np.argmax(np.linalg.norm(pts - pts[0], axis=1)))
    if i1 == 0:
        return np.asarray(chain[:1], np.int64)
    half1 = pts[: i1 + 1]
    half2 = np.concatenate([pts[i1:], pts[:1]], axis=0)
    k1 = _dp_open(half1, eps)      # indices 0..i1 (original k)
    k2 = _dp_open(half2, eps)      # indices 0..n-i1 (original (i1+k) % n)
    # k1 ends at i1 (== k2's first) and k2 ends at the wrap to 0 (== k1's
    # first) — drop both duplicates.
    idx = k1[:-1] + [(i1 + k) % n for k in k2[:-1]]
    return np.rint(pts[idx]).astype(np.int64)


# from mask3d_tpu/baseline/polygonize.py:164 fill_polygon
def fill_polygon(poly: np.ndarray, h: int, w: int) -> np.ndarray:
    """Rasterize a polygon with integer vertices into an [h, w] f32 mask
    (cv2.fillPoly semantics to within boundary-pixel rounding): a pixel is
    filled when its center-on-lattice point (x, y) lies inside or on the
    polygon (crossing number with boundary inclusion)."""
    from mask3d_tpu_torch.preprocess.geometry import points_in_polygon

    if len(poly) < 3:
        return np.zeros((h, w), np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float64)
    # Nudge test points off edge degeneracies the same way rasterizers do
    # (half-open pixel rule); include the boundary by testing a point just
    # inside the pixel.
    inside = points_in_polygon(pts + 0.25, np.asarray(poly, np.float64))
    inside |= points_in_polygon(pts - 0.25, np.asarray(poly, np.float64))
    return inside.reshape(h, w).astype(np.float32)


# from mask3d_tpu/baseline/polygonize.py:183 polygonize_mask
def polygonize_mask(mask: np.ndarray, degree: float = 0.01,
                    return_mask: bool = True):
    """Reference `Evaluator.polygonize_mask` (`Evaluator.py:25-60`):
    largest-area outer contour of `mask == 1`, simplified with
    epsilon = degree * perimeter; optionally also the re-filled map.

    Returns (poly i64[K, 2] in (x, y), filled f32[h, w]) when
    `return_mask`, else just the polygon. Empty mask -> empty polygon.
    """
    m = np.asarray(mask) == 1
    h, w = m.shape
    if not m.any():
        poly = np.zeros((0, 2), np.int64)
        return (poly, np.zeros((h, w), np.float32)) if return_mask else poly

    from scipy.ndimage import label

    lab, n = label(m, structure=np.ones((3, 3), np.int64))
    best_chain, best_area = None, -1.0
    for comp in range(1, n + 1):
        cm = lab == comp
        idx = np.flatnonzero(cm.ravel())
        y0, x0 = divmod(int(idx[0]), w)
        chain = trace_outer_contour(cm, (x0, y0))
        area = contour_area(chain)
        if area > best_area:
            best_area, best_chain = area, chain

    eps = degree * arc_length(best_chain, closed=True)
    poly = approx_poly_dp(best_chain, eps)
    if not return_mask:
        return poly
    return poly, fill_polygon(poly, h, w)
