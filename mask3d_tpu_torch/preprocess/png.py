"""Greyscale PNG reader and writer on the standard library's `zlib`.

The Structured3D panorama converter reads its depth maps with this reader
where the JAX package calls `cv2.imread(path, IMREAD_ANYDEPTH |
IMREAD_ANYCOLOR)` (mask3d_tpu/preprocess/stru3d.py:258 `_read_depth`): the
port runs where neither OpenCV nor PIL is installed.

Supported: 8- and 16-bit greyscale (colour type 0), not interlaced, any
mix of the five row filters (None, Sub, Up, Average, Paeth). Samples come
back as `uint8` / `uint16` [H, W], the 16-bit ones read big-endian as
OpenCV returns them. Anything else (another colour type or bit depth,
Adam7 interlacing, a chunk whose CRC is wrong, a truncated or oversized
image stream, a missing IEND) raises `PNGError` naming the file.

Average and Paeth are sequential along a row, so the unfilter step runs in
C++ (`png_unfilter` in `csrc/voxelizer.cpp`, bound in `native.py`) by
default; `use_native=False` runs `unfilter_numpy`, the reference it is
held to.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)
IDAT_BYTES = 1 << 16  # the writer's largest IDAT chunk


class PNGError(ValueError):
    """A PNG this reader does not read, or a damaged one."""


def _chunks(data: bytes, name: str):
    """(type, payload) of each chunk, CRCs checked, up to IEND."""
    if data[:8] != SIGNATURE:
        raise PNGError(f"{name}: not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise PNGError(f"{name}: truncated (no IEND chunk)")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise PNGError(f"{name}: truncated {ctype!r} chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise PNGError(f"{name}: bad CRC in {ctype!r} chunk")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def unfilter_numpy(raw: np.ndarray, h: int, row_bytes: int, bpp: int
                   ) -> np.ndarray:
    """Reference unfilter: raw uint8[h * (1 + row_bytes)] (a filter byte
    before each row) -> uint8[h, row_bytes]. Raises ValueError on an
    unknown filter type."""
    rows = np.asarray(raw, np.uint8).reshape(h, 1 + row_bytes)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == FILTER_NONE:
            cur = line.copy()
        elif ftype == FILTER_SUB:
            # each byte lane (x mod bpp) is a running sum mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == FILTER_UP:
            cur = line + prev
        elif ftype in (FILTER_AVERAGE, FILTER_PAETH):
            f, b = line.tolist(), prev.tolist()
            r = [0] * row_bytes
            for x in range(row_bytes):
                a = r[x - bpp] if x >= bpp else 0
                if ftype == FILTER_AVERAGE:
                    pred = (a + b[x]) >> 1
                else:
                    pred = _paeth(a, b[x], b[x - bpp] if x >= bpp else 0)
                r[x] = (f[x] + pred) & 0xFF
            cur = np.asarray(r, np.uint8)
        else:
            raise ValueError(f"row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def unfilter(raw: np.ndarray, h: int, row_bytes: int, bpp: int,
             use_native: bool = True) -> np.ndarray:
    """The unfilter step, C++ by default (`native.png_unfilter_native`)
    or the numpy reference; both raise ValueError on an unknown filter."""
    if use_native:
        from mask3d_tpu_torch.native import png_unfilter_native

        return png_unfilter_native(raw, h, row_bytes, bpp)
    return unfilter_numpy(raw, h, row_bytes, bpp)


def read_png(path: str, use_native: bool = True) -> np.ndarray:
    """8- or 16-bit greyscale PNG -> uint8 / uint16 [H, W]."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            if len(payload) != 13:
                raise PNGError(f"{path}: bad IHDR length {len(payload)}")
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise PNGError(f"{path}: no IHDR chunk")
    w, h, depth, color, comp, filt, interlace = header
    if color != 0 or depth not in (8, 16):
        raise PNGError(f"{path}: colour type {color} at bit depth {depth};"
                       " only 8- or 16-bit greyscale is read")
    if comp != 0 or filt != 0:
        raise PNGError(f"{path}: unknown compression {comp} or filter "
                       f"method {filt}")
    if interlace != 0:
        raise PNGError(f"{path}: interlaced (Adam7) PNGs are not read")
    if not idat or w == 0 or h == 0:
        raise PNGError(f"{path}: empty image")
    bpp = depth // 8
    row_bytes = w * bpp
    dec = zlib.decompressobj()
    try:
        raw = dec.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{path}: corrupt image stream: {e}") from e
    if not dec.eof or len(raw) != h * (1 + row_bytes):
        raise PNGError(f"{path}: image stream holds {len(raw)} bytes, "
                       f"{h * (1 + row_bytes)} expected"
                       + ("" if dec.eof else " (truncated)"))
    try:
        pix = unfilter(np.frombuffer(raw, np.uint8), h, row_bytes, bpp,
                       use_native=use_native)
    except ValueError as e:
        raise PNGError(f"{path}: {e}") from e
    if bpp == 1:
        return pix
    return pix.reshape(-1).view(">u2").reshape(h, w).astype(np.uint16)


def filter_rows(pix: np.ndarray, filters: np.ndarray, bpp: int
                ) -> np.ndarray:
    """uint8[h, row_bytes] -> the filtered stream uint8[h, 1 + row_bytes],
    row y filtered with filters[y]. Filtering reads only the original
    bytes, so it needs no loop along a row."""
    h, n = pix.shape
    x = pix.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    pred = preds[filters, np.arange(h)]
    out = np.empty((h, 1 + n), np.uint8)
    out[:, 0] = filters
    out[:, 1:] = ((x - pred) & 0xFF).astype(np.uint8)
    return out


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(path: str, img: np.ndarray,
              filters: Union[int, Sequence[int]] = FILTER_NONE) -> None:
    """uint8 or uint16 [H, W] -> greyscale PNG; row y is filtered with
    `filters[y]` (one int filters every row alike), and the image stream
    is split into IDAT chunks of at most `IDAT_BYTES`."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"need uint8 or uint16 [H, W], got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    bpp = img.dtype.itemsize
    f = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    if ((f < 0) | (f > 4)).any():
        raise ValueError("filter types are 0..4")
    pix = img.astype(img.dtype.newbyteorder(">")).view(np.uint8)
    stream = zlib.compress(filter_rows(pix.reshape(h, w * bpp), f, bpp)
                           .tobytes())
    parts = [SIGNATURE, _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8 * bpp, 0, 0, 0, 0))]
    parts += [_chunk(b"IDAT", stream[s:s + IDAT_BYTES])
              for s in range(0, len(stream), IDAT_BYTES)]
    parts.append(_chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
