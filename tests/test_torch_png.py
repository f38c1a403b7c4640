"""The port's greyscale PNG reader and writer
(`mask3d_tpu_torch/preprocess/png.py`): what OpenCV writes, the port reads
to the same array without OpenCV; the C++ unfilter equals the numpy
reference on every filter type; what the port does not read raises."""

import struct
import zlib

import numpy as np
import pytest

from mask3d_tpu_torch import native
from mask3d_tpu_torch.preprocess import png


def _cv2_read(path):
    import cv2

    return cv2.imread(str(path), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)


def _image(rng, dtype, h=37, w=53):
    """Noise below, smooth ramps above: libpng picks different filters
    for the two."""
    top = np.iinfo(dtype).max
    img = rng.integers(0, top, (h, w)).astype(dtype)
    img[: h // 2] = (np.add.outer(np.arange(h // 2) * 31,
                                  np.arange(w) * 97) % top).astype(dtype)
    return img


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("level", [0, 3, 9])
def test_reads_what_cv2_writes(tmp_path, dtype, level):
    import cv2

    img = _image(np.random.default_rng(level), dtype)
    path = tmp_path / "d.png"
    assert cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    want = _cv2_read(path)
    for use_native in (True, False):
        got = png.read_png(str(path), use_native=use_native)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_writer_round_trips_every_filter(tmp_path, dtype):
    """Each row filtered by its own type (all five in turn, several IDAT
    chunks): OpenCV and both unfilters read back what was written."""
    img = _image(np.random.default_rng(1), dtype)
    path = tmp_path / "d.png"
    png.write_png(str(path), img, np.arange(len(img)) % 5)
    path.write_bytes(_split_idat(path.read_bytes(), 97))
    assert np.array_equal(_cv2_read(path), img)
    for use_native in (True, False):
        assert np.array_equal(png.read_png(str(path), use_native), img)


@pytest.mark.parametrize("bpp", [1, 2])
def test_cxx_unfilter_matches_numpy(bpp):
    """Random filtered bytes under every filter type (byte wrap-around,
    Paeth's ties) and hand-built rows of each type, C++ against numpy."""
    rng = np.random.default_rng(bpp)
    h, row_bytes = 40, 24 * bpp
    raw = rng.integers(0, 256, (h, 1 + row_bytes)).astype(np.uint8)
    raw[:, 0] = np.arange(h) % 5
    raw[10:15, 1:] = 255  # sums that wrap
    raw[20:25, 1:] = 0  # Paeth ties
    want = png.unfilter_numpy(raw.reshape(-1), h, row_bytes, bpp)
    got = native.png_unfilter_native(raw.reshape(-1), h, row_bytes, bpp)
    assert np.array_equal(got, want)
    # rows of one filter type each: filtering then unfiltering is identity
    pix = rng.integers(0, 256, (h, row_bytes)).astype(np.uint8)
    for ftype in range(5):
        stream = png.filter_rows(pix, np.full(h, ftype), bpp)
        for use_native in (True, False):
            back = png.unfilter(stream.reshape(-1), h, row_bytes, bpp,
                                use_native=use_native)
            assert np.array_equal(back, pix), (ftype, use_native)


def _rewrite(data: bytes, ctype: bytes, edit) -> bytes:
    """`data` with the payload of its first `ctype` chunk replaced by
    edit(payload), the CRC recomputed."""
    pos = 8
    while True:
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == ctype:
            new = edit(data[pos + 8:pos + 8 + n])
            chunk = (struct.pack(">I", len(new)) + ctype + new
                     + struct.pack(">I", zlib.crc32(ctype + new)))
            return data[:pos] + chunk + data[pos + 12 + n:]
        pos += 12 + n


def _split_idat(data: bytes, size: int) -> bytes:
    """`data` (one IDAT chunk) with its image stream in IDAT chunks of at
    most `size` bytes."""
    stream = _idat(data)
    pos = data.index(b"IDAT") - 4
    end = pos + 12 + len(stream)
    chunks = b"".join(
        struct.pack(">I", len(part)) + b"IDAT" + part
        + struct.pack(">I", zlib.crc32(b"IDAT" + part))
        for part in (stream[s:s + size] for s in range(0, len(stream), size)))
    assert len(stream) > 2 * size
    return data[:pos] + chunks + data[end:]


def _bad_pngs(tmp_path):
    """(name, bytes, message fragment) of PNGs the reader must refuse."""
    import cv2

    gray = _image(np.random.default_rng(2), np.uint16, 16, 20)
    good_path = tmp_path / "good.png"
    png.write_png(str(good_path), gray)
    good = good_path.read_bytes()
    rgb_path = tmp_path / "rgb.png"
    cv2.imwrite(str(rgb_path), np.zeros((8, 8, 3), np.uint8))
    stream = zlib.decompress(_idat(good))

    def interlace(p):
        return p[:12] + b"\x01"

    def filter5(p):
        s = bytearray(stream)
        s[0] = 5
        return zlib.compress(bytes(s))

    def truncated(p):
        return zlib.compress(stream)[:-20]

    def bit_depth_1(p):
        return p[:8] + b"\x01" + p[9:]

    bad_crc = bytearray(good)
    bad_crc[len(good) - 20] ^= 0xFF  # a byte of the IDAT payload
    return [
        ("rgb", rgb_path.read_bytes(), "colour type 2"),
        ("interlaced", _rewrite(good, b"IHDR", interlace), "interlaced"),
        ("bad_crc", bytes(bad_crc), "bad CRC"),
        ("truncated_idat", _rewrite(good, b"IDAT", truncated), "truncated"),
        ("no_iend", good[:-12], "no IEND"),
        ("filter_5", _rewrite(good, b"IDAT", filter5), "filter type 5"),
        ("bit_depth_1", _rewrite(good, b"IHDR", bit_depth_1), "bit depth 1"),
        ("not_png", b"GIF89a" + good[6:], "signature"),
    ]


def _idat(data: bytes) -> bytes:
    out, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            out += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


@pytest.mark.parametrize("use_native", [True, False])
def test_refuses_what_it_does_not_read(tmp_path, use_native):
    for name, data, fragment in _bad_pngs(tmp_path):
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        with pytest.raises(png.PNGError, match=fragment) as e:
            png.read_png(str(path), use_native=use_native)
        assert str(path) in str(e.value), name


def test_writer_refuses_bad_input(tmp_path):
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "a.png"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "a.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "a.png"), np.zeros((4, 4), np.uint8), 5)
