"""Minimal LAS 1.4 reader/writer with extra-bytes dimensions (no laspy).

A copy of mask3d_tpu/data/las.py (numpy only).

Covers the subset the reference uses via laspy: point format 3 (xyz + gps
time + rgb) with named extra dimensions, header offsets/scales
(`point_cloud_reader_stru3d.py:544-559`, `mask3d/utils/utils.py:284-366`).
Extra dimensions are declared through the standard Extra Bytes VLR (user id
"LASF_Spec", record id 4).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

_HDR_SIZE = 375  # LAS 1.4
_PF3_SIZE = 34
# Extra-bytes data_type codes (subset)
_EB_TYPES = {
    1: "u1", 3: "u2", 5: "u4", 4: "i2", 6: "i4", 8: "i8", 9: "f4", 10: "f8",
    2: "i1", 7: "u8",
}
_EB_CODES = {v: k for k, v in _EB_TYPES.items()}


# from mask3d_tpu/data/las.py:27 write_las
def write_las(
    path: str,
    coords: np.ndarray,
    extra_dims: Dict[str, np.ndarray] = None,
    rgb: np.ndarray = None,
    scales: Sequence[float] = (1.0, 1.0, 1.0),
    offsets: Sequence[float] = None,
):
    """coords: f[n, 3] in world units; extra_dims: name -> array."""
    extra_dims = extra_dims or {}
    n = len(coords)
    coords = np.asarray(coords, np.float64)
    offsets = np.asarray(
        offsets if offsets is not None else coords.min(axis=0), np.float64
    ) if n else np.zeros(3)
    scales = np.asarray(scales, np.float64)

    eb_records = b""
    extra_size = 0
    packed_extras = []
    for name, arr in extra_dims.items():
        arr = np.asarray(arr)
        code = _EB_CODES[arr.dtype.str[1:]]
        rec = bytearray(192)
        rec[2] = code
        nm = name.encode("ascii")[:32]
        rec[4:4 + len(nm)] = nm
        eb_records += bytes(rec)
        extra_size += arr.dtype.itemsize
        packed_extras.append((name, arr))

    vlrs = b""
    n_vlr = 0
    if eb_records:
        desc = b"extra bytes"
        vlr_hdr = struct.pack(
            "<H16sHH32s", 0, b"LASF_Spec", 4, len(eb_records),
            desc.ljust(32, b"\0"),
        )
        vlrs = vlr_hdr + eb_records
        n_vlr = 1

    point_size = _PF3_SIZE + extra_size
    offset_to_points = _HDR_SIZE + len(vlrs)

    ixyz = np.round((coords - offsets) / scales).astype(np.int64)
    dt_fields = [
        ("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
        ("intensity", "<u2"), ("flags", "u1"), ("cls", "u1"),
        ("scan_angle", "i1"), ("user", "u1"), ("src", "<u2"),
        ("gps", "<f8"),
        ("red", "<u2"), ("green", "<u2"), ("blue", "<u2"),
    ]
    for name, arr in packed_extras:
        dt_fields.append((f"ed_{name}", "<" + arr.dtype.str[1:]))
    rec = np.zeros(n, dtype=np.dtype(dt_fields))
    rec["x"], rec["y"], rec["z"] = ixyz[:, 0], ixyz[:, 1], ixyz[:, 2]
    if rgb is not None:
        rgb = np.asarray(rgb)
        rec["red"], rec["green"], rec["blue"] = (
            rgb[:, 0], rgb[:, 1], rgb[:, 2]
        )
    for name, arr in packed_extras:
        rec[f"ed_{name}"] = arr
    assert rec.dtype.itemsize == point_size

    mins = coords.min(axis=0) if n else np.zeros(3)
    maxs = coords.max(axis=0) if n else np.zeros(3)

    hdr = bytearray(_HDR_SIZE)
    hdr[0:4] = b"LASF"
    hdr[24] = 1  # version major
    hdr[25] = 4  # version minor
    struct.pack_into("<H", hdr, 94, _HDR_SIZE)  # header size
    struct.pack_into("<I", hdr, 96, offset_to_points)
    struct.pack_into("<I", hdr, 100, n_vlr)
    hdr[104] = 3  # point data format
    struct.pack_into("<H", hdr, 105, point_size)
    struct.pack_into("<I", hdr, 107, min(n, 0xFFFFFFFF))  # legacy count
    struct.pack_into("<3d", hdr, 131, *scales)
    struct.pack_into("<3d", hdr, 155, *offsets)
    struct.pack_into(
        "<6d", hdr, 179, maxs[0], mins[0], maxs[1], mins[1], maxs[2], mins[2]
    )
    struct.pack_into("<Q", hdr, 247, n)  # 1.4 extended count

    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(vlrs)
        f.write(rec.tobytes())


# from mask3d_tpu/data/las.py:119 read_las
def read_las(path: str) -> Dict[str, np.ndarray]:
    """Returns {"xyz": f8[n,3], <extra_dim>: arr, "rgb": u2[n,3]}."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"LASF", "not a LAS file"
    header_size = struct.unpack_from("<H", data, 94)[0]
    offset_to_points = struct.unpack_from("<I", data, 96)[0]
    n_vlr = struct.unpack_from("<I", data, 100)[0]
    pdf = data[104]
    point_size = struct.unpack_from("<H", data, 105)[0]
    n = struct.unpack_from("<I", data, 107)[0]
    scales = np.array(struct.unpack_from("<3d", data, 131))
    offsets = np.array(struct.unpack_from("<3d", data, 155))
    if data[25] >= 4:
        n14 = struct.unpack_from("<Q", data, 247)[0]
        if n14:
            n = n14

    # Parse VLRs for extra-bytes descriptors
    extra: List[Tuple[str, str]] = []
    pos = header_size
    for _ in range(n_vlr):
        user_id = data[pos + 2:pos + 18].rstrip(b"\0")
        record_id = struct.unpack_from("<H", data, pos + 18)[0]
        length = struct.unpack_from("<H", data, pos + 20)[0]
        payload = data[pos + 54:pos + 54 + length]
        if user_id == b"LASF_Spec" and record_id == 4:
            for off in range(0, len(payload), 192):
                rec = payload[off:off + 192]
                code = rec[2]
                name = rec[4:36].split(b"\0")[0].decode()
                extra.append((name, _EB_TYPES[code]))
        pos += 54 + length

    base = _PF3_SIZE if pdf == 3 else None
    assert base is not None, f"unsupported point format {pdf}"
    dt_fields = [
        ("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
        ("intensity", "<u2"), ("flags", "u1"), ("cls", "u1"),
        ("scan_angle", "i1"), ("user", "u1"), ("src", "<u2"),
        ("gps", "<f8"),
        ("red", "<u2"), ("green", "<u2"), ("blue", "<u2"),
    ]
    for name, t in extra:
        dt_fields.append((f"ed_{name}", "<" + t))
    dt = np.dtype(dt_fields)
    assert dt.itemsize == point_size, (dt.itemsize, point_size)
    rec = np.frombuffer(data, dtype=dt, count=n, offset=offset_to_points)
    out = {
        "xyz": np.stack(
            [rec["x"], rec["y"], rec["z"]], axis=1
        ).astype(np.float64) * scales + offsets,
        "rgb": np.stack([rec["red"], rec["green"], rec["blue"]], axis=1),
    }
    for name, _ in extra:
        out[name] = np.ascontiguousarray(rec[f"ed_{name}"])
    return out
