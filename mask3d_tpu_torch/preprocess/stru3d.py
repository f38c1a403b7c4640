"""Structured3D panorama -> labelled point cloud: a copy of
mask3d_tpu/preprocess/stru3d.py, numpy on the host as there.

Semantics (reference `point_cloud_reader_stru3d.py`):
- spherical unprojection of equirectangular depth, skipping depth <= 500mm
  (`:268-284`)
- floor polygons from annotation_3d.json; "undefined" polygons >= 1.5 m^2
  become "other", else "invalid" (`:174-181`); door/window/outwall/invalid
  get room_id 0 (`:184-191`); room ids count up over floor polygons
- 15mm polygon buffer against wall gaps (`:199-212`)
- multi-match resolution: single match wins as-is; otherwise invalid-type
  matches are dropped, then non-door/window ("high priority") polygons win
  over door/window; first match in polygon order breaks ties; conflicting
  high-priority types raise (`:290-380`)
- coordinates rounded to 10mm in x/y and 100mm in z, then unique
  (`:476-483`)
- output records (x, y, z, type, room_id); type map `:114-137`

Differences from the JAX module, none in what it writes: depth PNGs are
read by the port's own reader (`preprocess/png.py`, no OpenCV);
`PanoramaSceneConverter.generate` records its phases' seconds in
`timings`; `main` runs its workers in a `spawn` pool, so that a caller
holding a CUDA context is never forked.

    python -m mask3d_tpu_torch.preprocess.stru3d --data_root <root> \\
        [--num_workers N] [--scene scene_NNNNN]
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np

from mask3d_tpu_torch.data.las import write_las
from mask3d_tpu_torch.data.ply import write_ply
from mask3d_tpu_torch.preprocess.geometry import (
    points_match_polygon,
    polygon_area,
)
from mask3d_tpu_torch.preprocess.png import read_png

# from mask3d_tpu/preprocess/stru3d.py:35 ROOM_ID_INVALID
ROOM_ID_INVALID = 0

# from mask3d_tpu/preprocess/stru3d.py:37 SEMANTIC_TYPE_INT_MAP
SEMANTIC_TYPE_INT_MAP = {
    "undefined": 0,
    "living room": 1,
    "kitchen": 2,
    "bedroom": 3,
    "bathroom": 4,
    "balcony": 5,
    "corridor": 6,
    "dining room": 7,
    "study": 8,
    "studio": 9,
    "store room": 10,
    "garden": 11,
    "laundry room": 12,
    "office": 13,
    "basement": 14,
    "garage": 15,
    "door": 17,
    "window": 18,
    "outwall": 19,
    "other": 20,
    "invalid": 21,
}
# from mask3d_tpu/preprocess/stru3d.py:60 NO_ROOM_ID_TYPES
NO_ROOM_ID_TYPES = ("door", "window", "outwall", "invalid")
# from mask3d_tpu/preprocess/stru3d.py:61 LOWER_PRIORITY_TYPES
LOWER_PRIORITY_TYPES = ("door", "window")
# from mask3d_tpu/preprocess/stru3d.py:62 POLYGON_BUFFER_MM
POLYGON_BUFFER_MM = 15.0
# from mask3d_tpu/preprocess/stru3d.py:63 MIN_OTHER_AREA_MM2
MIN_OTHER_AREA_MM2 = 1_500_000.0  # 1.5 m^2
# from mask3d_tpu/preprocess/stru3d.py:64 MIN_DEPTH_MM
MIN_DEPTH_MM = 500.0


# from mask3d_tpu/preprocess/stru3d.py:67 _lines_to_vertices
def _lines_to_vertices(line_pairs: List[List[int]]) -> List[List[int]]:
    """Chain line segments (vertex-id pairs) into closed vertex loops
    (reference `_convert_lines_to_vertices`, `:218-242`)."""
    loops = []
    remaining = [list(p) for p in line_pairs]
    loop: Optional[List[int]] = None
    while remaining:
        if loop is None:
            loop = remaining.pop(0)
            continue
        for i, pair in enumerate(remaining):
            if loop[-1] in pair:
                a, b = pair
                loop.append(b if loop[-1] == a else a)
                remaining.pop(i)
                break
        else:
            loops.append(loop[:-1] if loop[0] == loop[-1] else loop)
            loop = None
    if loop is not None:
        loops.append(loop[:-1] if loop[0] == loop[-1] else loop)
    return loops


# from mask3d_tpu/preprocess/stru3d.py:91 extract_floor_polygons
def extract_floor_polygons(annotations: dict) -> List[dict]:
    """Floor polygons with semantic type + room id (reference get_polygons)."""
    junctions = {j["ID"]: j["coordinate"] for j in annotations["junctions"]}
    polygons = []
    room_id_counter = 1
    for semantic in annotations["semantics"]:
        for plane_id in semantic["planeID"]:
            if annotations["planes"][plane_id]["type"] != "floor":
                continue
            line_ids = np.nonzero(
                np.asarray(annotations["planeLineMatrix"][plane_id])
            )[0]
            pairs = [
                np.nonzero(
                    np.asarray(annotations["lineJunctionMatrix"][li])
                )[0].tolist()
                for li in line_ids
            ]
            loops = _lines_to_vertices(pairs)
            assert len(loops) == 1, "floor plane must form one polygon"
            for loop in loops:
                coords2d = np.asarray(
                    [junctions[j][:2] for j in loop], np.float64
                )
                sem_type = semantic["type"]
                if sem_type == "undefined":
                    sem_type = (
                        "other"
                        if polygon_area(coords2d) >= MIN_OTHER_AREA_MM2
                        else "invalid"
                    )
                if sem_type not in NO_ROOM_ID_TYPES:
                    room_id = room_id_counter
                    room_id_counter += 1
                else:
                    room_id = ROOM_ID_INVALID
                polygons.append(
                    {
                        "coords2d": coords2d,
                        "semantic_type": sem_type,
                        "room_id": room_id,
                    }
                )
    return polygons


# from mask3d_tpu/preprocess/stru3d.py:137 unproject_panorama
def unproject_panorama(depth_img: np.ndarray, camera_center: np.ndarray,
                       random_level: float = 0.0,
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
    """Equirectangular depth -> global xyz (vectorized `_generate_point`).

    Returns [M, 3] for the pixels with depth > 500mm.
    """
    h, w = depth_img.shape
    x_tick = 180.0 / h
    y_tick = 360.0 / w
    xs = np.arange(h)[:, None]
    ys = np.arange(w)[None, :]
    depth = depth_img.astype(np.float64)
    if random_level and rng is not None:
        depth = depth + rng.random(depth.shape) * random_level
    keep = depth > MIN_DEPTH_MM

    alpha = np.deg2rad(90.0 - xs * x_tick)  # elevation
    beta = np.deg2rad(ys * y_tick - 180.0)  # azimuth
    z = depth * np.sin(alpha)
    xy = depth * np.cos(alpha)
    x = xy * np.sin(beta)
    y = xy * np.cos(beta)
    pts = np.stack(
        [x[keep], y[keep], np.broadcast_to(z, depth.shape)[keep]], axis=1
    )
    return pts + np.asarray(camera_center)[None, :]


# from mask3d_tpu/preprocess/stru3d.py:167 label_points
def label_points(points_xy: np.ndarray, polygons: List[dict]
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Assign (type, room_id) per point — vectorized reference decision tree.

    Reference `_generate_point` (`:290-380`): single match wins even if
    invalid; multi-match drops invalid, prefers non-door/window, first
    polygon in annotation order breaks ties; conflicting non-door/window
    types raise.
    """
    n = len(points_xy)
    match = np.zeros((len(polygons), n), bool)
    for i, poly in enumerate(polygons):
        match[i] = points_match_polygon(
            points_xy, poly["coords2d"], buffer=POLYGON_BUFFER_MM
        )
    n_match = match.sum(axis=0)

    types = np.zeros(n, np.int32)  # undefined
    rooms = np.full(n, ROOM_ID_INVALID, np.int32)

    poly_types = np.asarray(
        [SEMANTIC_TYPE_INT_MAP[p["semantic_type"]] for p in polygons]
    )
    poly_rooms = np.asarray([p["room_id"] for p in polygons])
    is_invalid = poly_types == SEMANTIC_TYPE_INT_MAP["invalid"]
    is_low = np.isin(
        poly_types,
        [SEMANTIC_TYPE_INT_MAP[t] for t in LOWER_PRIORITY_TYPES],
    )

    # Selection priority per point: (1) exactly-one-match takes that polygon;
    # (2) otherwise first matching non-invalid high-priority polygon;
    # (3) else first matching non-invalid polygon; (4) else undefined.
    first_any = np.argmax(match, axis=0)
    single = n_match == 1
    types[single] = poly_types[first_any[single]]
    rooms[single] = poly_rooms[first_any[single]]

    multi = n_match > 1
    if multi.any():
        m = match[:, multi] & ~is_invalid[:, None]
        has_valid = m.any(axis=0)
        m_high = m & ~is_low[:, None]
        has_high = m_high.any(axis=0)

        # conflicting high-priority types raise, like the reference.
        if has_high.any():
            sel = m_high[:, has_high]
            t = np.where(sel, poly_types[:, None], -1)
            t_sorted = np.sort(t, axis=0)
            uniq_hi = (
                (t_sorted[1:] != t_sorted[:-1]) & (t_sorted[1:] >= 0)
                & (t_sorted[:-1] >= 0)
            ).sum(axis=0) + 1
            if (uniq_hi > 1).any():
                raise ValueError(
                    "conflicting non-door/window polygon types for a point"
                )

        pick = np.where(
            has_high, np.argmax(m_high, axis=0), np.argmax(m, axis=0)
        )
        idx_multi = np.nonzero(multi)[0]
        use = has_valid
        types[idx_multi[use]] = poly_types[pick[use]]
        rooms[idx_multi[use]] = poly_rooms[pick[use]]
    return types, rooms


# from mask3d_tpu/preprocess/stru3d.py:236 PanoramaSceneConverter
class PanoramaSceneConverter:
    """Per-scene driver (reference PointCloudReaderPanorama)."""

    def __init__(self, scene_path: str, resolution: str = "full",
                 random_level: float = 0.0, seed: int = 0):
        self.scene_path = scene_path
        self.rng = np.random.default_rng(seed)
        self.random_level = random_level
        cam_dir = os.path.join(scene_path, "2D_rendering")
        self.rooms = sorted(os.listdir(cam_dir)) if os.path.isdir(cam_dir) \
            else []
        self.depth_paths, self.camera_paths = [], []
        for room in self.rooms:
            base = os.path.join(cam_dir, room, "panorama")
            self.depth_paths.append(
                os.path.join(base, resolution, "depth.png")
            )
            self.camera_paths.append(os.path.join(base, "camera_xyz.txt"))
        with open(os.path.join(scene_path, "annotation_3d.json")) as f:
            self.annotations = json.load(f)
        self.polygons = extract_floor_polygons(self.annotations)
        self.timings: dict = {}

    # from mask3d_tpu/preprocess/stru3d.py:258 _read_depth
    def _read_depth(self, path: str) -> np.ndarray:
        return read_png(path)

    # from mask3d_tpu/preprocess/stru3d.py:265 _read_camera_center
    def _read_camera_center(self, path: str) -> np.ndarray:
        with open(path) as f:
            vals = list(map(float, f.readline().strip().split(" ")))
        return np.asarray(vals[:3])

    # from mask3d_tpu/preprocess/stru3d.py:270 generate
    def generate(self) -> dict:
        """The labelled, rounded, unique cloud; `timings` gets the seconds
        of its phases (read, unproject, label, unique)."""
        tm = dict(read=0.0, unproject=0.0, label=0.0, unique=0.0)
        all_pts = []
        for dpath, cpath in zip(self.depth_paths, self.camera_paths):
            t = time.perf_counter()
            depth = self._read_depth(dpath)
            center = self._read_camera_center(cpath)
            tm["read"] += time.perf_counter() - t
            t = time.perf_counter()
            all_pts.append(
                unproject_panorama(
                    depth, center, self.random_level, self.rng
                )
            )
            tm["unproject"] += time.perf_counter() - t
        coords = np.concatenate(all_pts) if all_pts else np.zeros((0, 3))
        t = time.perf_counter()
        types, rooms = label_points(coords[:, :2], self.polygons)
        tm["label"] = time.perf_counter() - t

        # Round to 10mm xy / 100mm z then unique (`:476-483`).
        t = time.perf_counter()
        coords = coords.copy()
        coords[:, :2] = np.round(coords[:, :2] / 10.0) * 10.0
        coords[:, 2] = np.round(coords[:, 2] / 100.0) * 100.0
        _, uniq = np.unique(coords, axis=0, return_index=True)
        tm["unique"] = time.perf_counter() - t
        self.timings = tm
        return {
            "coords": coords[uniq],
            "types": types[uniq],
            "room_ids": rooms[uniq],
        }

    # from mask3d_tpu/preprocess/stru3d.py:294 export
    def export(self, ply_path: str, las_path: Optional[str] = None):
        pc = self.generate()
        write_ply(
            ply_path,
            {
                "x": pc["coords"][:, 0].astype(np.float32),
                "y": pc["coords"][:, 1].astype(np.float32),
                "z": pc["coords"][:, 2].astype(np.float32),
                "type": pc["types"].astype(np.int32),
                "room_id": pc["room_ids"].astype(np.int32),
            },
        )
        if las_path:
            write_las(
                las_path,
                pc["coords"],
                extra_dims={
                    "type": pc["types"].astype(np.int32),
                    "room_id": pc["room_ids"].astype(np.int32),
                },
            )
        return pc


# from mask3d_tpu/preprocess/stru3d.py:318 convert_scene
def convert_scene(scene_path: str, out_dir: Optional[str] = None) -> dict:
    """Per-scene entry with the reference's success/failure bookkeeping
    (`generate_point_cloud_stru3d.py:39-54`); a success also carries its
    seconds, the converter's `timings` and its point count."""
    import traceback

    scene = os.path.basename(scene_path.rstrip("/"))
    t = time.perf_counter()
    try:
        out_dir = out_dir or scene_path
        conv = PanoramaSceneConverter(scene_path)
        pc = conv.export(
            os.path.join(out_dir, "point_cloud.ply"),
            os.path.join(out_dir, "point_cloud.las"),
        )
        return {"scene": scene, "success": True, "points": len(pc["coords"]),
                "seconds": time.perf_counter() - t, "timings": conv.timings}
    except Exception:
        return {
            "scene": scene,
            "success": False,
            "exception": traceback.format_exc(),
        }


# from mask3d_tpu/preprocess/stru3d.py:340 main
def main(argv=None):
    """Converts every scene (or `--scene`) under `--data_root`, writes
    `run_valid_scenes.txt` there and returns the per-scene results."""
    import argparse
    import multiprocessing

    ap = argparse.ArgumentParser(
        description="Structured3D panoramas -> labelled point clouds"
    )
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--num_workers", type=int, default=1)
    ap.add_argument("--scene", default=None)
    args = ap.parse_args(argv)

    scenes = (
        [args.scene]
        if args.scene
        else sorted(
            s for s in os.listdir(args.data_root)
            if os.path.isdir(os.path.join(args.data_root, s))
        )
    )
    paths = [os.path.join(args.data_root, s) for s in scenes]
    if args.num_workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.num_workers) as pool:
            results = list(pool.imap(convert_scene, paths))
    else:
        results = [convert_scene(p) for p in paths]

    ok = [r["scene"] for r in results if r["success"]]
    bad = [r for r in results if not r["success"]]
    with open(os.path.join(args.data_root, "run_valid_scenes.txt"), "w") as f:
        f.write("\n".join(ok) + "\n")
    for r in bad:
        print(f"FAILED {r['scene']}:\n{r['exception']}")
    print(f"{len(ok)} scenes converted, {len(bad)} failed")
    return results


if __name__ == "__main__":
    main()
