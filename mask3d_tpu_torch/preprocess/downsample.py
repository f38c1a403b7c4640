"""Voxel-grid downsampling of labelled point clouds: a copy of
mask3d_tpu/preprocess/downsample.py, numpy on the host as there.

Grid-quantize `floor((p - min) / voxel_size)`, keep the first point per
voxel (np.unique order), emit
- `point_cloud_rasterized_{vs}.npy`  — dense label cuboid [X, Y, Z, 2]
- `point_cloud_rasterized_{vs}.ply`  — sparse integer-voxel records
- `point_cloud_rasterized_{vs}.las`  — same as .las
(reference `downsample_ply.py:51-127`). voxel_size is the
`data.rasterization_factor` that experiment 1 sweeps ({100, 150, 200} mm).
`native.downsample_native` is the C++ form of the quantize+unique.

    python -m mask3d_tpu_torch.preprocess.downsample --data_root <root> \\
        --voxel_size 150 [--scene S | --scenes_file F] [--num_workers N]

`main` runs its workers in a `spawn` pool, so that a caller holding a CUDA
context is never forked.
"""

from __future__ import annotations

import os

import numpy as np

from mask3d_tpu_torch.data.las import write_las
from mask3d_tpu_torch.data.ply import read_ply, write_ply


# from mask3d_tpu/preprocess/downsample.py:24 downsample_point_cloud
def downsample_point_cloud(coords: np.ndarray, types: np.ndarray,
                           room_ids: np.ndarray, voxel_size: float):
    """Returns (rasterized_cuboid [X,Y,Z,2], sparse records dict)."""
    mins = coords.min(axis=0)
    maxs = coords.max(axis=0)
    vox = np.floor((coords - mins) / voxel_size).astype(np.int64)
    _, keep = np.unique(vox, axis=0, return_index=True)

    cuboid_size = np.ceil((maxs + 1 - mins) / voxel_size).astype(np.int64)
    cuboid = np.zeros((*cuboid_size, 2))
    kept_vox = vox[keep]
    cuboid[kept_vox[:, 0], kept_vox[:, 1], kept_vox[:, 2], 0] = types[keep]
    cuboid[kept_vox[:, 0], kept_vox[:, 1], kept_vox[:, 2], 1] = room_ids[keep]

    # Sparse output keeps the (origin-aligned) voxel coordinates
    # (`downsample_ply.py:98-104`, unordered_output_use_original_coords=False).
    out_coords = kept_vox + kept_vox.min(axis=0)
    sparse = {
        "x": out_coords[:, 0].astype(np.int32),
        "y": out_coords[:, 1].astype(np.int32),
        "z": out_coords[:, 2].astype(np.int32),
        "type": types[keep].astype(np.int32),
        "room_id": room_ids[keep].astype(np.int32),
    }
    return cuboid, sparse


# from mask3d_tpu/preprocess/downsample.py:51 downsample_scene
def downsample_scene(scene_dir: str, voxel_size: int,
                     in_name: str = "point_cloud.ply") -> dict:
    import traceback

    try:
        v = read_ply(os.path.join(scene_dir, in_name))
        coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
        cuboid, sparse = downsample_point_cloud(
            coords, np.asarray(v["type"]), np.asarray(v["room_id"]),
            voxel_size,
        )
        stem = os.path.join(
            scene_dir, f"point_cloud_rasterized_{voxel_size}"
        )
        np.save(stem + ".npy", cuboid)
        write_ply(stem + ".ply", sparse)
        write_las(
            stem + ".las",
            np.stack(
                [sparse["x"], sparse["y"], sparse["z"]], axis=1
            ).astype(np.float64),
            extra_dims={"type": sparse["type"], "room_id": sparse["room_id"]},
        )
        return {"scene": os.path.basename(scene_dir), "success": True,
                "voxels": len(sparse["x"])}
    except Exception:
        return {
            "scene": os.path.basename(scene_dir),
            "success": False,
            "exception": traceback.format_exc(),
        }


# from mask3d_tpu/preprocess/downsample.py:83 main
def main(argv=None):
    """Downsamples the scenes and returns their results."""
    import argparse
    import functools
    import multiprocessing

    ap = argparse.ArgumentParser(description="Voxel-downsample point clouds")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--voxel_size", type=int, default=150)
    ap.add_argument("--num_workers", type=int, default=1)
    ap.add_argument("--scene", default=None)
    ap.add_argument("--scenes_file", default=None)
    args = ap.parse_args(argv)

    if args.scene:
        scenes = [args.scene]
    elif args.scenes_file:
        with open(args.scenes_file) as f:
            scenes = [line.strip() for line in f if line.strip()]
    else:
        scenes = sorted(
            s for s in os.listdir(args.data_root)
            if os.path.isdir(os.path.join(args.data_root, s))
        )
    dirs = [os.path.join(args.data_root, s) for s in scenes]
    fn = functools.partial(downsample_scene, voxel_size=args.voxel_size)
    if args.num_workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.num_workers) as pool:
            results = list(pool.imap(fn, dirs))
    else:
        results = [fn(d) for d in dirs]
    bad = [r for r in results if not r["success"]]
    for r in bad:
        print(f"FAILED {r['scene']}:\n{r['exception']}")
    print(f"{len(results) - len(bad)} scenes downsampled, {len(bad)} failed")
    return results


if __name__ == "__main__":
    main()
