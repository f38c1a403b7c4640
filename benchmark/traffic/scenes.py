"""The one generator of the benchmark's traffic: scenes drawn from a seed.

A traffic file (`benchmark/traffic/<name>.json`) names a scene kind and
its parameters; `batches(traffic, seed)` draws `unique_batches` batches of
`batch_size` scenes, batch j from `numpy.random.default_rng([seed, j])`,
so every seed gives the same sizes and layout, in other draws.

The scene kinds are frozen copies of the program's generators, so that a
change to the program cannot move the yardstick:

- "rooms": `make_synthetic_scene` (a grid floor plan of axis-aligned rooms:
  floor, ceiling and walls as surface voxels, jitter and dropout), the
  scenes of the JAX bench (`bench.py:190-201`, `flagship_items`);
- "hall": `make_hall_scene` (`tools/bench_large_scene.py:29`): an open
  hall with floor, ceiling, two side walls and furniture-like boxes.

Each scene is the reference's item contract: "coordinates" f32[n, 3],
"features" (constant ones), "labels" i32[n, 2] (semantic, instance),
"raw_*" copies and "scene".
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _item(coords, labels, name):
    features = np.ones((len(coords), 1), np.float32)
    return {"coordinates": coords, "features": features, "labels": labels,
            "raw_coordinates": coords.copy(),
            "raw_features": features.copy(), "raw_labels": labels.copy(),
            "scene": name}


# frozen copy of mask3d_tpu_torch/data/synthetic.py make_synthetic_scene
def rooms_scene(rng: np.random.Generator, num_rooms_x: int = 3,
                num_rooms_y: int = 2, room_size: int = 24, height: int = 10,
                jitter: float = 0.3, dropout: float = 0.3,
                multi_floor: bool = False) -> dict:
    pts, inst = [], []
    floors = 2 if multi_floor else 1
    room_id = 0
    for fl in range(floors):
        z0 = fl * (height + 2)
        for rx in range(num_rooms_x):
            for ry in range(num_rooms_y):
                room_id += 1
                room_pts = []
                x0, y0 = rx * room_size, ry * room_size
                x1, y1 = x0 + room_size, y0 + room_size
                xs = np.arange(x0, x1)
                ys = np.arange(y0, y1)
                gx, gy = np.meshgrid(xs, ys, indexing="ij")
                gx, gy = gx.ravel(), gy.ravel()
                for zz in (z0, z0 + height - 1):
                    room_pts.append(
                        np.stack([gx, gy, np.full_like(gx, zz)], 1))
                zs = np.arange(z0, z0 + height)
                for wx in (x0, x1 - 1):
                    wgy, wgz = np.meshgrid(ys, zs, indexing="ij")
                    room_pts.append(np.stack(
                        [np.full(wgy.size, wx), wgy.ravel(), wgz.ravel()],
                        1))
                for wy in (y0, y1 - 1):
                    wgx, wgz = np.meshgrid(xs, zs, indexing="ij")
                    room_pts.append(np.stack(
                        [wgx.ravel(), np.full(wgx.size, wy), wgz.ravel()],
                        1))
                room_pts = np.concatenate(room_pts)
                pts.append(room_pts)
                inst.append(np.full(len(room_pts), room_id, np.int32))
    coords = np.concatenate(pts).astype(np.float32)
    instance = np.concatenate(inst)
    semantic = np.ones(len(coords), np.int32)
    if jitter > 0:
        coords = coords + rng.normal(scale=jitter, size=coords.shape).astype(
            np.float32)
    if dropout > 0:
        keep = rng.random(len(coords)) > dropout
        coords, semantic, instance = (coords[keep], semantic[keep],
                                      instance[keep])
    labels = np.stack([semantic, instance], axis=-1).astype(np.int32)
    return _item(coords, labels, f"rooms_{rng.integers(1 << 30)}")


# frozen copy of mask3d_tpu_torch/bench_large_scene.py make_hall_scene
def hall_scene(rng: np.random.Generator, length: int = 1920,
               width: int = 160, height: int = 64,
               n_boxes: int = 260) -> dict:
    xs = np.arange(length)
    ys = np.arange(width)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    gx, gy = gx.ravel(), gy.ravel()
    pts = [np.stack([gx, gy, np.zeros_like(gx)], 1),
           np.stack([gx, gy, np.full_like(gx, height - 1)], 1)]
    zs = np.arange(height)
    wgx, wgz = np.meshgrid(xs, zs, indexing="ij")
    for wy in (0, width - 1):
        pts.append(np.stack(
            [wgx.ravel(), np.full(wgx.size, wy), wgz.ravel()], 1))
    for _ in range(n_boxes):
        sx = int(rng.integers(6, 40))
        sy = int(rng.integers(6, 24))
        sz = int(rng.integers(4, 20))
        x0 = int(rng.integers(0, length - sx))
        y0 = int(rng.integers(1, width - 1 - sy))
        bx = np.arange(x0, x0 + sx)
        by = np.arange(y0, y0 + sy)
        bz = np.arange(1, 1 + sz)
        fx, fy = np.meshgrid(bx, by, indexing="ij")
        pts.append(np.stack(
            [fx.ravel(), fy.ravel(), np.full(fx.size, 1 + sz)], 1))
        wx, wz = np.meshgrid(bx, bz, indexing="ij")
        for yy in (y0, y0 + sy - 1):
            pts.append(np.stack(
                [wx.ravel(), np.full(wx.size, yy), wz.ravel()], 1))
        wy2, wz2 = np.meshgrid(by, bz, indexing="ij")
        for xx in (x0, x0 + sx - 1):
            pts.append(np.stack(
                [np.full(wy2.size, xx), wy2.ravel(), wz2.ravel()], 1))
    coords = np.concatenate(pts).astype(np.float32)
    coords += rng.normal(scale=0.3, size=coords.shape).astype(np.float32)
    seg = np.clip(coords[:, 0] // (length // 12), 0, 11).astype(np.int32)
    labels = np.stack([np.ones_like(seg), seg], 1)
    return _item(coords, labels, "hall")


KINDS = {"rooms": rooms_scene, "hall": hall_scene}


def batches(traffic: Dict, seed: int) -> List[List[dict]]:
    """`traffic["unique_batches"]` batches of `traffic["batch_size"]`
    scenes of kind `traffic["scene"]` with `traffic["params"]`."""
    make = KINDS[traffic["scene"]]
    out = []
    for j in range(int(traffic["unique_batches"])):
        rng = np.random.default_rng([int(seed), j])
        out.append([make(rng, **traffic["params"])
                    for _ in range(int(traffic["batch_size"]))])
    return out
