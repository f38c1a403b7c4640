"""Synthetic multi-room indoor scenes for tests and benchmarks (a copy of
the JAX package's numpy generator: the same rng gives the same scene).

Generates voxelized point clouds with the same record schema as the
preprocessed Structured3D data (`(x, y, z, type, room_id)`; reference
`datasets_preprocess/structured3d_to_point_clouds/point_cloud_reader_stru3d.py:508-559`
and `downsample_ply.py:107-112`): a grid floor plan of axis-aligned rooms,
each contributing floor + ceiling + wall surface voxels, with the room's
instance id; walls between rooms get split between the adjoining rooms.

Statistics roughly match the dataset analysis (1-22 rooms per scene, avg ~6;
`datasets_preprocess/structured3d_analyze/stru3d_analyze_20241019.txt`).
"""

from __future__ import annotations

import numpy as np


# from mask3d_tpu/data/synthetic.py:19 make_synthetic_scene
def make_synthetic_scene(
    rng: np.random.Generator,
    num_rooms_x: int = 3,
    num_rooms_y: int = 2,
    room_size: int = 24,
    height: int = 10,
    jitter: float = 0.3,
    dropout: float = 0.3,
    multi_floor: bool = False,
) -> dict:
    """Returns a reference-contract item dict (see `VoxelizeCollate`)."""
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
                # floor + ceiling
                for zz in (z0, z0 + height - 1):
                    room_pts.append(
                        np.stack([gx, gy, np.full_like(gx, zz)], 1)
                    )
                # four walls (full height)
                zs = np.arange(z0, z0 + height)
                for wx in (x0, x1 - 1):
                    wgy, wgz = np.meshgrid(ys, zs, indexing="ij")
                    room_pts.append(
                        np.stack(
                            [np.full(wgy.size, wx), wgy.ravel(), wgz.ravel()],
                            1,
                        )
                    )
                for wy in (y0, y1 - 1):
                    wgx, wgz = np.meshgrid(xs, zs, indexing="ij")
                    room_pts.append(
                        np.stack(
                            [wgx.ravel(), np.full(wgx.size, wy), wgz.ravel()],
                            1,
                        )
                    )
                room_pts = np.concatenate(room_pts)
                pts.append(room_pts)
                inst.append(np.full(len(room_pts), room_id, np.int32))

    coords = np.concatenate(pts).astype(np.float32)
    instance = np.concatenate(inst)
    semantic = np.ones(len(coords), np.int32)  # all "is_room" class 1

    if jitter > 0:
        coords = coords + rng.normal(scale=jitter, size=coords.shape).astype(
            np.float32
        )
    if dropout > 0:
        keep = rng.random(len(coords)) > dropout
        coords, semantic, instance = coords[keep], semantic[keep], instance[keep]

    features = np.ones((len(coords), 1), np.float32)
    labels = np.stack([semantic, instance], axis=-1).astype(np.int32)
    return {
        "coordinates": coords,
        "features": features,
        "labels": labels,
        "raw_coordinates": coords.copy(),
        "raw_features": features.copy(),
        "raw_labels": labels.copy(),
        "scene": f"synthetic_{rng.integers(1 << 30)}",
    }


def floorplan_annotation(rooms) -> dict:
    """A Structured3D `annotation_3d.json` dict holding one floor plane per
    room: `rooms` is a list of (x0, y0, x1, y1, semantic type) rectangles
    (junctions at the corners, four lines each)."""
    n = len(rooms)
    junctions, semantics, planes = [], [], []
    plane_lines = [[0] * (4 * n) for _ in range(n)]
    line_junctions = [[0] * (4 * n) for _ in range(4 * n)]
    for r, (x0, y0, x1, y1, sem) in enumerate(rooms):
        for i, (x, y) in enumerate(((x0, y0), (x1, y0), (x1, y1),
                                    (x0, y1))):
            junctions.append({"ID": 4 * r + i,
                              "coordinate": [float(x), float(y), 0.0]})
            plane_lines[r][4 * r + i] = 1
            line_junctions[4 * r + i][4 * r + i] = 1
            line_junctions[4 * r + i][4 * r + (i + 1) % 4] = 1
        planes.append({"ID": r, "type": "floor"})
        semantics.append({"ID": r, "planeID": [r], "type": sem})
    return {"junctions": junctions, "planes": planes,
            "planeLineMatrix": plane_lines,
            "lineJunctionMatrix": line_junctions, "semantics": semantics}


def write_floorplan_scene(root: str, scene: str, rng: np.random.Generator,
                          num_rooms_x: int = 3, num_rooms_y: int = 2,
                          room_size: int = 24, height: int = 10) -> dict:
    """One scene of the Structured3D layout that `FloorplanDataset` reads:
    `point_cloud_rasterized_150.ply` (binary float32 x, y, z, int type and
    room_id) of `make_synthetic_scene` on one floor, and an
    `annotation_3d.json` whose floor polygons are its rooms in the PLY's
    frame (room ids count up in the same order). Returns the item."""
    import json
    import os

    from mask3d_tpu_torch.data.ply import write_ply

    item = make_synthetic_scene(rng, num_rooms_x, num_rooms_y, room_size,
                                height, jitter=0.3, dropout=0.3)
    c, lab = item["coordinates"], item["labels"]
    d = os.path.join(root, scene)
    os.makedirs(d, exist_ok=True)
    write_ply(os.path.join(d, "point_cloud_rasterized_150.ply"),
              {"x": c[:, 0], "y": c[:, 1], "z": c[:, 2],
               "type": lab[:, 0], "room_id": lab[:, 1]}, text=False)
    kinds = ("bedroom", "kitchen", "living room", "bathroom")
    rooms = [(rx * room_size, ry * room_size, (rx + 1) * room_size - 1,
              (ry + 1) * room_size - 1, kinds[(rx + ry) % len(kinds)])
             for rx in range(num_rooms_x) for ry in range(num_rooms_y)]
    with open(os.path.join(d, "annotation_3d.json"), "w") as f:
        json.dump(floorplan_annotation(rooms), f)
    return item


def room_box_depth(h: int, w: int, box, camera) -> np.ndarray:
    """An equirectangular depth panorama (uint16 mm, [h, w]) of the inside
    of an axis-aligned box (x0, y0, z0, x1, y1, z1) seen from `camera`
    (x, y, z) inside it: each pixel's ray, in the angles
    `preprocess.stru3d.unproject_panorama` reads (elevation 90 - row *
    180 / h, azimuth col * 360 / w - 180), cast to the nearest face."""
    alpha = np.deg2rad(90.0 - np.arange(h)[:, None] * (180.0 / h))
    beta = np.deg2rad(np.arange(w)[None, :] * (360.0 / w) - 180.0)
    d = np.stack(np.broadcast_arrays(np.cos(alpha) * np.sin(beta),
                                     np.cos(alpha) * np.cos(beta),
                                     np.sin(alpha)))
    lo = np.asarray(box[:3], np.float64)[:, None, None]
    hi = np.asarray(box[3:], np.float64)[:, None, None]
    c = np.asarray(camera, np.float64)[:, None, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(d > 0, (hi - c) / d, np.where(d < 0, (lo - c) / d,
                                                   np.inf))
    return np.round(t.min(axis=0)).astype(np.uint16)


# room types of the panorama scenes, in room order; their rooms' ceiling
# and camera heights
PANORAMA_ROOM_TYPES = ("living room", "kitchen", "bedroom", "bathroom",
                       "study", "dining room")
PANORAMA_CEILING_MM = 2800
PANORAMA_CAMERA_Z_MM = 1400


def panorama_rooms(num_rooms_x: int = 3, num_rooms_y: int = 2,
                   room_mm=(4800, 3800), wall_mm: int = 200) -> list:
    """The floor polygons of a grid of rooms with `wall_mm` walls between
    them, as (x0, y0, x1, y1, type) for `floorplan_annotation`, and a door
    across the wall between the first two rooms along x (or y)."""
    rx, ry = room_mm
    rooms = [(i * (rx + wall_mm), j * (ry + wall_mm),
              i * (rx + wall_mm) + rx, j * (ry + wall_mm) + ry,
              PANORAMA_ROOM_TYPES[(i * num_rooms_y + j)
                                  % len(PANORAMA_ROOM_TYPES)])
             for i in range(num_rooms_x) for j in range(num_rooms_y)]
    if num_rooms_x > 1:
        door = (rx - 100, ry // 2 - 450, rx + wall_mm + 100, ry // 2 + 450,
                "door")
    else:
        door = (rx // 2 - 450, ry - 100, rx // 2 + 450, ry + wall_mm + 100,
                "door")
    return rooms + [door]


def write_panorama_scene(root: str, scene: str, rooms: list,
                         pano_hw=(512, 1024), write_png=None) -> list:
    """One raw Structured3D scene: `annotation_3d.json` with the floor
    polygons `rooms` (`floorplan_annotation`, millimetres) and, for each
    room but doors and windows, `2D_rendering/<r>/panorama/full/depth.png`
    (`room_box_depth` of the room's box, floor to PANORAMA_CEILING_MM,
    from its centre at PANORAMA_CAMERA_Z_MM) with `camera_xyz.txt`.
    `write_png(path, depth)` writes each panorama (default: the port's
    `preprocess.png.write_png`, the rows' filter types 0-4 in turn).
    Returns the depths in room order."""
    import json
    import os

    if write_png is None:
        from mask3d_tpu_torch.preprocess import png

        def write_png(path, depth):
            png.write_png(path, depth, np.arange(len(depth)) % 5)
    d = os.path.join(root, scene)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "annotation_3d.json"), "w") as fh:
        json.dump(floorplan_annotation(rooms), fh)
    depths = []
    for r, (x0, y0, x1, y1, sem) in enumerate(
            q for q in rooms if q[4] not in ("door", "window")):
        cam = ((x0 + x1) / 2, (y0 + y1) / 2, PANORAMA_CAMERA_Z_MM)
        depth = room_box_depth(*pano_hw, (x0, y0, 0, x1, y1,
                                          PANORAMA_CEILING_MM), cam)
        pano = os.path.join(d, "2D_rendering", str(r), "panorama")
        os.makedirs(os.path.join(pano, "full"), exist_ok=True)
        write_png(os.path.join(pano, "full", "depth.png"), depth)
        with open(os.path.join(pano, "camera_xyz.txt"), "w") as fh:
            fh.write(f"{cam[0]} {cam[1]} {cam[2]}\n")
        depths.append(depth)
    return depths
