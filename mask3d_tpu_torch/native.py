"""Native host library: builds `csrc/voxelizer.cpp` with g++ and binds it
with ctypes.

A copy of the JAX package's loader (mask3d_tpu/native.py) for the C++
voxelizer that collation runs on every item, the u8 key encoders of the
bench's input path (`data/transfer.py`) and the offline downsampler's
quantize+unique, plus one function of the port's own: the depth PNG
reader's unfilter step (`preprocess/png.py`). One difference from the JAX
loader: a build that fails raises with the compiler's output, and no
wrapper returns None. Nothing falls back to numpy here;
`data.collate.voxelize_item(use_native=False)`, the encoders' and the PNG
reader's `use_native=False` are the numpy paths, run only where the caller
asks for them.

    g++ -O3 -march=native -shared -fPIC -std=c++17 csrc/voxelizer.cpp \\
        -o _build/libmask3d_host-<hash>.so

The build runs at first use, into `mask3d_tpu_torch/_build/`; the file name
carries a hash of the source, the flags and the host CPU's feature flags, so
an edited source, or another CPU, gets its own build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SRC = PKG_DIR / "csrc" / "voxelizer.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: `-march=native` code built on one
    machine may not run on another that shares the checkout."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")),
                        b"")
    except OSError:
        return b""


def _so_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode() + _cpu_flags()
    ).hexdigest()
    return BUILD_DIR / f"libmask3d_host-{digest[:12]}.so"


# from mask3d_tpu/native.py:33 _build
def _build() -> Path:
    """Compile the library unless it is built; raise on any failure."""
    so = _so_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Written under a private name and renamed: concurrent processes may
    # build at once, and none may load a half-written library.
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"native voxelizer build failed: {' '.join(cmd)}:"
                           f" {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native voxelizer build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)
    return so


# from mask3d_tpu/native.py:51 get_lib
def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.voxelize_f32.restype = ctypes.c_int
            lib.voxelize_f32.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            i32p, u8p = (ctypes.POINTER(ctypes.c_int32),
                         ctypes.POINTER(ctypes.c_uint8))
            lib.pack_encode_u8.restype = ctypes.c_int
            lib.pack_encode_u8.argtypes = [
                i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, u8p]
            lib.coarse_pyramid_encode_u8.restype = ctypes.c_int
            lib.coarse_pyramid_encode_u8.argtypes = [
                i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, u8p]
            lib.downsample_f64.restype = ctypes.c_int
            lib.downsample_f64.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_double, i32p, i32p]
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [
                u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, u8p]
            _lib = lib
        return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


# from mask3d_tpu/native.py:93 voxelize_native
def voxelize_native(coordinates: np.ndarray):
    """C++ path of `collate.voxelize_item`: (coords i32[m, 3] sorted
    unique, keep i32[m] into the input rows, dims i32[3])."""
    lib = get_lib()
    c = np.ascontiguousarray(coordinates, np.float32)
    if c.ndim != 2 or c.shape[1] != 3:
        raise ValueError(f"coordinates must be [n, 3], got {c.shape}")
    n = len(c)
    out_coords = np.empty((n, 3), np.int32)
    keep = np.empty(n, np.int32)
    dims = np.empty(3, np.int32)
    m = lib.voxelize_f32(
        _ptr(c, ctypes.c_float), n,
        _ptr(out_coords, ctypes.c_int32), _ptr(keep, ctypes.c_int32),
        _ptr(dims, ctypes.c_int32),
    )
    return out_coords[:m], keep[:m], dims


# from mask3d_tpu/native.py:111 pack_encode_u8_native
def pack_encode_u8_native(coords: np.ndarray, counts: np.ndarray,
                          dims: np.ndarray, escape_capacity: int = 4096
                          ) -> np.ndarray:
    """C++ fused `pack_keys` + `transfer.encode_keys_u8`: coords i32[B, N,
    3] sorted by key within counts -> the uint8 transfer buffer
    (byte-identical to the numpy path); raises ValueError on escape-table
    overflow or unsorted keys, as `encode_keys_u8` does."""
    lib = get_lib()
    c = np.ascontiguousarray(coords, np.int32)
    cnt = np.ascontiguousarray(counts, np.int32)
    dm = np.ascontiguousarray(dims, np.int32)
    b, n = c.shape[0], c.shape[1]
    out = np.empty(b * n + escape_capacity * 12 + b * 16, np.uint8)
    rc = lib.pack_encode_u8(
        _ptr(c, ctypes.c_int32), _ptr(cnt, ctypes.c_int32),
        _ptr(dm, ctypes.c_int32), b, n, escape_capacity,
        _ptr(out, ctypes.c_uint8))
    if rc == -1:
        raise ValueError(f"escapes exceed capacity {escape_capacity}")
    if rc == -2:
        raise ValueError("keys not sorted ascending within counts")
    return out


# from mask3d_tpu/native.py:139 coarse_pyramid_encode_u8_native
def coarse_pyramid_encode_u8_native(coords: np.ndarray, counts: np.ndarray,
                                    dims: np.ndarray, level_capacities,
                                    escape_capacity: int = 1024
                                    ) -> np.ndarray:
    """C++ fused coarse-pyramid build + per-level u8-delta encode
    (`transfer.coarse_pyramid_host` + `encode_keys_u8` per level, the
    sections concatenated, byte-identical); raises ValueError on
    escape-table overflow."""
    lib = get_lib()
    c = np.ascontiguousarray(coords, np.int32)
    cnt = np.ascontiguousarray(counts, np.int32)
    dm = np.ascontiguousarray(dims, np.int32)
    caps = np.ascontiguousarray(level_capacities, np.int64)
    b, n = c.shape[0], c.shape[1]
    total = int(sum(b * int(cap) + escape_capacity * 12 + b * 16
                    for cap in caps))
    out = np.empty(total, np.uint8)
    rc = lib.coarse_pyramid_encode_u8(
        _ptr(c, ctypes.c_int32), _ptr(cnt, ctypes.c_int32),
        _ptr(dm, ctypes.c_int32), b, n, _ptr(caps, ctypes.c_int64),
        len(caps), escape_capacity, _ptr(out, ctypes.c_uint8))
    if rc == -1:
        raise ValueError(f"escapes exceed capacity {escape_capacity}")
    return out


# from mask3d_tpu/native.py:167 downsample_native
def downsample_native(coords: np.ndarray, voxel_size: float):
    """C++ quantize+unique of `preprocess.downsample`: (vox i32[m, 3] =
    floor((p - min) / voxel_size) of the first point of each voxel, in
    ascending (x, y, z) order; keep i32[m] into the input rows), as
    `np.unique(vox, axis=0, return_index=True)` gives them."""
    lib = get_lib()
    c = np.ascontiguousarray(coords, np.float64)
    if c.ndim != 2 or c.shape[1] != 3:
        raise ValueError(f"coords must be [n, 3], got {c.shape}")
    n = len(c)
    out_vox = np.empty((n, 3), np.int32)
    keep = np.empty(n, np.int32)
    m = lib.downsample_f64(
        _ptr(c, ctypes.c_double), n, voxel_size,
        _ptr(out_vox, ctypes.c_int32), _ptr(keep, ctypes.c_int32),
    )
    return out_vox[:m], keep[:m]


def png_unfilter_native(raw: np.ndarray, h: int, row_bytes: int, bpp: int
                        ) -> np.ndarray:
    """C++ PNG unfilter (`preprocess.png.unfilter_numpy` is its
    reference): raw uint8[h * (1 + row_bytes)] -> uint8[h, row_bytes];
    raises ValueError on an unknown filter type."""
    if h < 0 or row_bytes < 0 or not 1 <= bpp <= 8:
        raise ValueError(f"bad PNG geometry: {h} rows of {row_bytes} bytes,"
                         f" {bpp} bytes a pixel")
    lib = get_lib()
    r = np.ascontiguousarray(raw, np.uint8)
    if r.size != h * (1 + row_bytes):
        raise ValueError(f"raw holds {r.size} bytes, {h * (1 + row_bytes)}"
                         " expected")
    out = np.empty((h, row_bytes), np.uint8)
    rc = lib.png_unfilter(_ptr(r, ctypes.c_uint8), h, row_bytes, bpp,
                          _ptr(out, ctypes.c_uint8))
    if rc < 0:
        raise ValueError(f"row {-rc - 1}: unknown filter type "
                         f"{int(r[(-rc - 1) * (1 + row_bytes)])}")
    return out
