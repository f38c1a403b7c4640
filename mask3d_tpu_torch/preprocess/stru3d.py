"""Structured3D floor polygons from `annotation_3d.json`: the part of
mask3d_tpu/preprocess/stru3d.py that the baseline reads (the panorama
renderer is not ported).

Semantics (reference `point_cloud_reader_stru3d.py`): floor polygons from
annotation_3d.json; "undefined" polygons >= 1.5 m^2 become "other", else
"invalid" (`:174-181`); door/window/outwall/invalid get room_id 0
(`:184-191`); room ids count up over floor polygons.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from mask3d_tpu_torch.preprocess.geometry import polygon_area

# from mask3d_tpu/preprocess/stru3d.py:35 ROOM_ID_INVALID
ROOM_ID_INVALID = 0
# from mask3d_tpu/preprocess/stru3d.py:60 NO_ROOM_ID_TYPES
NO_ROOM_ID_TYPES = ("door", "window", "outwall", "invalid")
# from mask3d_tpu/preprocess/stru3d.py:63 MIN_OTHER_AREA_MM2
MIN_OTHER_AREA_MM2 = 1_500_000.0  # 1.5 m^2


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
