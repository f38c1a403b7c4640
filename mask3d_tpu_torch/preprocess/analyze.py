"""Dataset statistics reports: a copy of mask3d_tpu/preprocess/analyze.py.

Per-scene room counts, undefined-polygon counts/areas and aggregate
statistics (reference `structured3d_analyze.py` and
`matterport3d_analyze.py`).

    python -m mask3d_tpu_torch.preprocess.analyze --data_root <root> \\
        [--out report.txt]
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from mask3d_tpu_torch.preprocess.geometry import polygon_area
from mask3d_tpu_torch.preprocess.stru3d import (
    MIN_OTHER_AREA_MM2,
    extract_floor_polygons,
)


# from mask3d_tpu/preprocess/analyze.py:25 analyze_scene
def analyze_scene(scene_path: str) -> dict:
    with open(os.path.join(scene_path, "annotation_3d.json")) as f:
        annotations = json.load(f)
    polys = extract_floor_polygons(annotations)
    rooms = [p for p in polys if p["room_id"] > 0]
    undefined_like = [
        p for p in polys if p["semantic_type"] in ("other", "invalid")
    ]
    return {
        "scene": os.path.basename(scene_path.rstrip("/")),
        "num_rooms": len(rooms),
        "num_undefined_polygons": len(undefined_like),
        "undefined_areas_m2": [
            polygon_area(p["coords2d"]) / 1e6 for p in undefined_like
        ],
        "num_other": sum(
            1 for p in undefined_like if p["semantic_type"] == "other"
        ),
    }


# from mask3d_tpu/preprocess/analyze.py:46 aggregate
def aggregate(stats: List[dict]) -> dict:
    rooms = np.asarray([s["num_rooms"] for s in stats])
    return {
        "num_scenes": len(stats),
        "rooms_min": int(rooms.min()) if len(rooms) else 0,
        "rooms_max": int(rooms.max()) if len(rooms) else 0,
        "rooms_mean": float(rooms.mean()) if len(rooms) else 0.0,
        "rooms_median": float(np.median(rooms)) if len(rooms) else 0.0,
        "num_undefined_total": int(
            sum(s["num_undefined_polygons"] for s in stats)
        ),
        "num_other_total": int(sum(s["num_other"] for s in stats)),
        "min_other_area_m2": MIN_OTHER_AREA_MM2 / 1e6,
    }


# from mask3d_tpu/preprocess/analyze.py:62 main
def main(argv=None):
    """Prints (and with `--out` writes) the report; returns the
    aggregate."""
    import argparse

    ap = argparse.ArgumentParser(description="Analyze dataset annotations")
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    scenes = sorted(
        s for s in os.listdir(args.data_root)
        if os.path.isdir(os.path.join(args.data_root, s))
    )
    stats = []
    for s in scenes:
        try:
            stats.append(analyze_scene(os.path.join(args.data_root, s)))
        except Exception as e:
            print(f"skipping {s}: {e}")
    agg = aggregate(stats)
    lines = [f"{k}: {v}" for k, v in agg.items()]
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return agg


if __name__ == "__main__":
    main()
