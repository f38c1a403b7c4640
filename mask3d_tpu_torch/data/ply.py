"""Self-contained PLY reader/writer (no plyfile dependency).

A copy of mask3d_tpu/data/ply.py (numpy only).

Reads/writes the dataset artifact schema of the reference preprocessing:
ASCII PLY with properties (x, y, z, type, room_id) as int32
(`datasets_preprocess/downsample_point_cloud/downsample_ply.py:15-17`
`PlyData(..., text=True)`;
`point_cloud_reader_stru3d.py:508-542` for the raw clouds). The reader also
handles binary_little_endian files (Matterport3D region segmentations are
binary PLY).
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_TYPES = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


# from mask3d_tpu/data/ply.py:35 read_ply
def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element into a dict of property arrays.

    Handles ascii and binary_little_endian formats; list properties (e.g.
    face indices) of non-vertex elements are skipped for ascii and supported
    enough to skip for binary files where vertex comes first.
    """
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header_end = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")

    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], f"list:{_PLY_TYPES[parts[2]]}:{_PLY_TYPES[parts[3]]}")
                )
            else:
                elements[-1][2].append((parts[-1], _PLY_TYPES[parts[1]]))

    body = data[header_end:]
    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        text = body.decode("ascii")
        offset_lines = 0
        lines = text.splitlines()
        for name, count, props in elements:
            if name != "vertex":
                offset_lines += count
                continue
            assert all(not t.startswith("list") for _, t in props), (
                "list properties in vertex element not supported"
            )
            arr = np.loadtxt(
                io.StringIO("\n".join(lines[offset_lines:offset_lines + count])),
                dtype=np.float64,
                ndmin=2,
            )
            for i, (pname, ptype) in enumerate(props):
                out[pname] = arr[:, i].astype(np.dtype(ptype))
            offset_lines += count
            break
        return out

    if fmt == "binary_little_endian":
        offset = 0
        for name, count, props in elements:
            if any(t.startswith("list") for _, t in props):
                if name == "vertex":
                    raise ValueError("list properties in vertex unsupported")
                # Cannot skip variable-length records cheaply; stop if vertex
                # was already read.
                if out:
                    break
                raise ValueError(f"{path}: list element before vertex")
            dt = np.dtype([(p, "<" + t) for p, t in props])
            if name == "vertex":
                arr = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                for pname, _ in props:
                    out[pname] = np.ascontiguousarray(arr[pname])
            offset += dt.itemsize * count
        return out

    raise ValueError(f"{path}: unsupported PLY format {fmt}")


# from mask3d_tpu/data/ply.py:114 write_ply
def write_ply(path: str, arrays: Dict[str, np.ndarray], text: bool = True):
    """Write a single 'vertex' element (property order = dict order)."""
    names = list(arrays.keys())
    n = len(arrays[names[0]])
    cols = [np.asarray(arrays[k]) for k in names]
    lines = ["ply"]
    lines.append(
        "format ascii 1.0" if text else "format binary_little_endian 1.0"
    )
    lines.append(f"element vertex {n}")
    for k, c in zip(names, cols):
        lines.append(f"property {_INV_TYPES[c.dtype.str[1:]]} {k}")
    lines.append("end_header")
    header = "\n".join(lines) + "\n"
    if text:
        with open(path, "w") as f:
            f.write(header)
            stacked = np.stack([c.astype(np.float64) for c in cols], axis=1)
            int_like = all(c.dtype.kind in "iu" for c in cols)
            fmt = "%d" if int_like else "%.6g"
            np.savetxt(f, stacked, fmt=fmt)
    else:
        dt = np.dtype([(k, "<" + c.dtype.str[1:]) for k, c in zip(names, cols)])
        rec = np.empty(n, dtype=dt)
        for k, c in zip(names, cols):
            rec[k] = c
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(rec.tobytes())
