"""Matterport3D region merge: a copy of
mask3d_tpu/preprocess/matterport.py.

Merge a scan's per-region `.ply` files into one labelled cloud, assigning
`room_id = region_index + 1` and `type = 1`, converting meters to
millimeters; regions are processed in sorted order (reference
`download_and_preprocess.py:23-96`).

    python -m mask3d_tpu_torch.preprocess.matterport --data_root <scans> \\
        --out_root <out>
    python -m mask3d_tpu_torch.preprocess.matterport --out_root <out> \\
        --download_mp <path/to/download_mp.py> [--id SCAN]

The second form drives the user's own copy of Matterport's `download_mp.py`
(which may not be redistributed); this module downloads nothing itself.
"""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from mask3d_tpu_torch.data.las import write_las
from mask3d_tpu_torch.data.ply import read_ply, write_ply


# from mask3d_tpu/preprocess/matterport.py:22 merge_regions
def merge_regions(region_dir: str) -> dict:
    files: List[str] = sorted(
        f for f in os.listdir(region_dir) if re.fullmatch(r"region\d+\.ply", f)
    )
    coords_all, rooms_all, rgb_all = [], [], []
    for idx, fname in enumerate(files):
        v = read_ply(os.path.join(region_dir, fname))
        coords = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
        coords *= 1000.0  # m -> mm
        coords_all.append(coords)
        rooms_all.append(np.full(len(coords), idx + 1, np.int32))
        if "red" in v:  # reference keeps vertex colors (`:53-58,79-81`)
            rgb_all.append(np.stack(
                [v["red"], v["green"], v["blue"]], axis=1
            ).astype(np.uint16))
    coords = np.concatenate(coords_all) if coords_all else np.zeros((0, 3))
    rooms = np.concatenate(rooms_all) if rooms_all else np.zeros(0, np.int32)
    out = {
        "coords": coords,
        "types": np.ones(len(coords), np.int32),
        "room_ids": rooms,
    }
    if rgb_all and len(rgb_all) == len(coords_all):
        out["rgb"] = np.concatenate(rgb_all)
    return out


# from mask3d_tpu/preprocess/matterport.py:49 preprocess_scan
def preprocess_scan(scan_dir: str, out_dir: str) -> dict:
    import traceback

    scan = os.path.basename(scan_dir.rstrip("/"))
    try:
        region_dir = os.path.join(scan_dir, "region_segmentations")
        if not os.path.isdir(region_dir):
            region_dir = scan_dir
        pc = merge_regions(region_dir)
        os.makedirs(out_dir, exist_ok=True)
        write_ply(
            os.path.join(out_dir, "point_cloud.ply"),
            {
                "x": pc["coords"][:, 0].astype(np.float32),
                "y": pc["coords"][:, 1].astype(np.float32),
                "z": pc["coords"][:, 2].astype(np.float32),
                "type": pc["types"],
                "room_id": pc["room_ids"],
            },
        )
        write_las(
            os.path.join(out_dir, "point_cloud.las"),
            pc["coords"],
            extra_dims={"type": pc["types"], "room_id": pc["room_ids"]},
            rgb=pc.get("rgb"),
        )
        return {"scene": scan, "success": True}
    except Exception:
        return {
            "scene": scan,
            "success": False,
            "exception": traceback.format_exc(),
        }


# ---------------------------------------------------------------------------
# Download driver (reference download_and_preprocess.py:92-147). Matterport
# forbids redistributing its `download_mp.py`; the reference imports the
# user-obtained copy (`:12-18`) and so does this driver — supply its path.
# ---------------------------------------------------------------------------

# from mask3d_tpu/preprocess/matterport.py:90 RELEVANT_FILE_TYPES
RELEVANT_FILE_TYPES = ["region_segmentations"]  # reference `:20`


# from mask3d_tpu/preprocess/matterport.py:93 load_download_mp
def load_download_mp(path: str):
    """Import the user-supplied `download_mp.py` and check it honors the
    contract the reference relies on (BASE_URL, RELEASE, download_scan,
    get_release_scans)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("download_mp", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in ("BASE_URL", "RELEASE", "download_scan", "get_release_scans"):
        if not hasattr(mod, attr):
            raise AttributeError(
                f"{path} lacks `{attr}` — not a Matterport download_mp.py"
            )
    return mod


# from mask3d_tpu/preprocess/matterport.py:112 process_scan
def process_scan(mod, scan_id: str, out_dir: str) -> dict:
    """Download one scan's region segmentations, merge, write the `.las`,
    drop the temp download (reference `process_scan` + `preprocess_scene`,
    download_and_preprocess.py:23-96)."""
    import shutil
    from zipfile import ZipFile

    release = mod.RELEASE
    temp_dir = os.path.join(out_dir, "temp", release, scan_id)
    final_dir = os.path.join(out_dir, "preprocessed", release, scan_id)
    mod.download_scan(scan_id, temp_dir, RELEVANT_FILE_TYPES)

    zip_path = os.path.join(temp_dir, "region_segmentations.zip")
    unzip_path = os.path.join(temp_dir, "region_segmentations")
    with ZipFile(zip_path, "r") as z:
        z.extractall(path=unzip_path)
    os.unlink(zip_path)
    region_dir = os.path.join(unzip_path, scan_id, "region_segmentations")

    res = preprocess_scan_regions(region_dir, final_dir, scene=scan_id)
    shutil.rmtree(temp_dir, ignore_errors=True)
    return res


# from mask3d_tpu/preprocess/matterport.py:136 preprocess_scan_regions
def preprocess_scan_regions(region_dir: str, out_dir: str,
                            scene: str) -> dict:
    import traceback

    try:
        pc = merge_regions(region_dir)
        os.makedirs(out_dir, exist_ok=True)
        write_las(
            os.path.join(out_dir, "point_cloud.las"),
            pc["coords"],
            extra_dims={"type": pc["types"], "room_id": pc["room_ids"]},
            rgb=pc.get("rgb"),
        )
        return {"scene": scene, "success": True}
    except Exception:
        return {
            "scene": scene, "success": False,
            "exception": traceback.format_exc(),
        }


# from mask3d_tpu/preprocess/matterport.py:157 download_and_preprocess
def download_and_preprocess(out_dir: str, scan: str = "ALL",
                            download_mp_path: str = "download_mp.py"
                            ) -> List[dict]:
    """Reference `main` (download_and_preprocess.py:99-147): fetch the
    release scan list, then download+preprocess one scan or all of them.
    Existing preprocessed scan dirs are skipped like the reference's
    partial-download semantics."""
    mod = load_download_mp(download_mp_path)
    release_scans = mod.get_release_scans(mod.BASE_URL + mod.RELEASE + ".txt")
    if scan not in ("ALL", "all"):
        if scan not in release_scans:
            raise ValueError(f"invalid scan id: {scan}")
        scans = [scan]
    else:
        scans = list(release_scans)
    results = []
    for sid in scans:
        final_dir = os.path.join(
            out_dir, "preprocessed", mod.RELEASE, sid
        )
        if os.path.exists(os.path.join(final_dir, "point_cloud.las")):
            results.append({"scene": sid, "success": True, "skipped": True})
            continue
        results.append(process_scan(mod, sid, out_dir))
    return results


# from mask3d_tpu/preprocess/matterport.py:184 main
def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Merge Matterport3D regions (and optionally drive the "
                    "download via a user-supplied download_mp.py)"
    )
    ap.add_argument("--data_root")
    ap.add_argument("--out_root")
    ap.add_argument("--download_mp", default=None,
                    help="path to the Matterport download_mp.py; with "
                         "--out_root this downloads+preprocesses like the "
                         "reference download_and_preprocess.py")
    ap.add_argument("--id", default="ALL",
                    help="scan id to download, or ALL")
    args = ap.parse_args(argv)

    if args.download_mp:
        if not args.out_root:
            ap.error("--download_mp requires --out_root")
        results = download_and_preprocess(
            args.out_root, args.id, args.download_mp
        )
        bad = [r for r in results if not r["success"]]
        for r in bad:
            print(f"FAILED {r['scene']}:\n{r['exception']}")
        print(f"{len(results) - len(bad)} scans done, {len(bad)} failed")
        return
    if not (args.data_root and args.out_root):
        ap.error("merge mode requires --data_root and --out_root")
    scans = sorted(
        s for s in os.listdir(args.data_root)
        if os.path.isdir(os.path.join(args.data_root, s))
    )
    results = [
        preprocess_scan(
            os.path.join(args.data_root, s), os.path.join(args.out_root, s)
        )
        for s in scans
    ]
    bad = [r for r in results if not r["success"]]
    for r in bad:
        print(f"FAILED {r['scene']}:\n{r['exception']}")
    print(f"{len(results) - len(bad)} scans merged, {len(bad)} failed")


if __name__ == "__main__":
    main()
