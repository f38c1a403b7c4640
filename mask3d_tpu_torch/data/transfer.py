"""The JAX bench's input codec: a batch's sorted voxel keys, and every
coarse level's keys, in one uint8 buffer.

The collator's per-item sorted linearized keys have small first
differences, so a batch ships as

  [B*N u8 deltas][EC escape records (item, pos, value) i32][B i32 counts
  | B*3 i32 dims]

Deltas >= 255 (each item's first key among them) are marked with the 255
sentinel and carried exactly in the escape table; the decode is one scatter
and one cumsum. `encode_pyramid_u8` appends each coarse level of the stride
pyramid, computed on the host (`coarse_pyramid_host`), in the same layout,
so the device skips the per-level compaction and builds the sparse batch
with `build_sparse_batch(precomputed_levels=...)`.

The encoders run on the host: the C++ library (`native.py`) by default,
the numpy copies of the JAX package's functions with `use_native=False`
(byte-identical). The decoders are torch functions on the buffer's device;
`to_device` copies a host buffer from pinned memory without a host sync.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from mask3d_tpu_torch import native


# from mask3d_tpu/data/transfer.py:32 encode_keys_u8
def encode_keys_u8(keys, counts, dims, escape_capacity: int = 4096
                   ) -> np.ndarray:
    """keys i32[B, N] (sorted ascending per item over the first counts[b]
    rows; padding rows arbitrary), counts i32[B], dims i32[B, 3] ->
    uint8[B*N + escape_capacity*12 + B*16]. Raises ValueError if the keys
    need more than `escape_capacity` escape records."""
    keys = np.asarray(keys, np.int64)
    counts = np.asarray(counts, np.int32)
    dims = np.asarray(dims, np.int32)
    b, n = keys.shape

    d = np.zeros((b, n), np.int64)
    d[:, 0] = keys[:, 0]
    d[:, 1:] = np.diff(keys, axis=1)
    rows = np.arange(n)[None, :]
    d[rows >= counts[:, None]] = 0
    if (d < 0).any():
        raise ValueError("keys not sorted ascending within counts")

    esc = d >= 255
    ei, ep = np.nonzero(esc)
    if len(ei) > escape_capacity:
        raise ValueError(
            f"{len(ei)} escapes exceed capacity {escape_capacity}")
    records = np.zeros((escape_capacity, 3), np.int32)
    records[: len(ei), 0] = ei
    records[: len(ei), 1] = ep
    records[: len(ei), 2] = d[ei, ep]
    records[len(ei):, 1] = n  # out-of-range position: the decode drops it

    deltas = np.minimum(d, 255).astype(np.uint8)
    tail = np.concatenate([counts[:, None], dims], axis=1).astype(np.int32)
    return np.concatenate([deltas.reshape(-1),
                           records.view(np.uint8).reshape(-1),
                           tail.view(np.uint8).reshape(-1)])


def _pack_keys_np(coords, dims):
    """`sparse.core.pack_keys` on numpy arrays, i32[B, N]."""
    c = np.asarray(coords, np.int64)
    d = np.asarray(dims, np.int64)[:, None, :]
    return ((c[..., 0] * d[..., 1] + c[..., 1]) * d[..., 2]
            + c[..., 2]).astype(np.int32)


# from mask3d_tpu/data/transfer.py:76 encode_batch_u8
def encode_batch_u8(coords, counts, dims, escape_capacity: int = 4096,
                    use_native: bool = True) -> np.ndarray:
    """`pack_keys` + `encode_keys_u8` of batch voxel coords i32[B, N, 3]
    (sorted by key within the first counts[b] rows, the collator's order):
    the C++ pass, or numpy with `use_native=False`."""
    if use_native:
        return native.pack_encode_u8_native(coords, counts, dims,
                                            escape_capacity)
    return encode_keys_u8(_pack_keys_np(coords, dims), counts, dims,
                          escape_capacity)


# from mask3d_tpu/data/transfer.py:97 coarse_pyramid_host
def coarse_pyramid_host(coords, counts, dims, level_capacities
                        ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The stride-2 pyramid's keys on the host, with the semantics of
    `dense_ops.downsample_level_dense`: per item, level l+1 is the sorted
    unique of (coords_l >> 1) packed in dims_{l+1} = ((dims_l - 1) >> 1) + 1.
    Rows past a level's capacity are cut from the shipped keys only (the
    device flags the overflow from the raw count); the next level derives
    from the full cell set, as the device pools the untruncated occupancy.

    Returns [(keys i32[B, cap_l], raw_counts i32[B], dims i32[B, 3])] per
    coarse level; a padding row repeats the item's last key (zero deltas).
    """
    coords = np.asarray(coords)
    counts = np.asarray(counts, np.int64)
    d = np.asarray(dims, np.int64)
    b = coords.shape[0]
    per_item = [coords[i, : counts[i]].astype(np.int64) for i in range(b)]
    out = []
    for cap in level_capacities:
        d = ((d - 1) >> 1) + 1
        keys = np.zeros((b, cap), np.int32)
        raw = np.zeros((b,), np.int32)
        nxt = []
        for i in range(b):
            c = per_item[i] >> 1
            k = np.unique((c[:, 0] * d[i, 1] + c[:, 1]) * d[i, 2] + c[:, 2])
            raw[i] = len(k)
            ks = k[:cap]
            keys[i, : len(ks)] = ks.astype(np.int32)
            if len(ks):
                keys[i, len(ks):] = np.int32(ks[-1])
            z = k % d[i, 2]
            r = k // d[i, 2]
            nxt.append(np.stack([r // d[i, 1], r % d[i, 1], z], axis=-1))
        per_item = nxt
        out.append((keys, raw, d.astype(np.int32)))
    return out


# from mask3d_tpu/data/transfer.py:144 encode_pyramid_u8
def encode_pyramid_u8(coords, counts, dims, level_capacities,
                      escape_capacity: int = 4096,
                      coarse_escape_capacity: int = 1024,
                      use_native: bool = True) -> np.ndarray:
    """One uint8 buffer: the base level (`encode_batch_u8`) then every
    coarse level's keys, raw counts and dims (`encode_keys_u8` each), at
    the offsets `pyramid_buf_sizes` gives; `decode_pyramid_u8` inverts."""
    base = encode_batch_u8(coords, counts, dims, escape_capacity, use_native)
    if use_native:
        coarse = native.coarse_pyramid_encode_u8_native(
            coords, counts, dims, level_capacities, coarse_escape_capacity)
        return np.concatenate([base, coarse])
    bufs = [base]
    for keys, raw, d in coarse_pyramid_host(coords, counts, dims,
                                            level_capacities):
        bufs.append(encode_keys_u8(keys, raw, d, coarse_escape_capacity))
    return np.concatenate(bufs)


# from mask3d_tpu/data/transfer.py:169 pyramid_buf_sizes
def pyramid_buf_sizes(batch, n_cap, level_capacities,
                      escape_capacity: int = 4096,
                      coarse_escape_capacity: int = 1024) -> List[int]:
    sizes = [batch * n_cap + escape_capacity * 12 + batch * 16]
    sizes += [batch * cap + coarse_escape_capacity * 12 + batch * 16
              for cap in level_capacities]
    return sizes


def to_device(buf, device) -> torch.Tensor:
    """A host uint8 buffer (numpy or tensor) on `device`: to a CUDA device
    from pinned memory with `non_blocking`, so the host does not wait for
    the copy; a tensor already there is returned as it is."""
    t = torch.as_tensor(buf)
    device = torch.device(device)
    if t.device.type == device.type and device.index in (None,
                                                         t.device.index):
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _as_i32(u8: torch.Tensor) -> torch.Tensor:
    """Bitcast a 1-D uint8 slice to int32. `view` needs a byte offset that
    is a multiple of 4; a coarse level's table can start elsewhere (an odd
    B * cap_l), and is then copied first."""
    if u8.storage_offset() % 4:
        u8 = u8.clone()
    return u8.view(torch.int32)


# from mask3d_tpu/data/transfer.py:209 decode_keys_u8
def decode_keys_u8(buf: torch.Tensor, batch: int, n: int,
                   escape_capacity: int = 4096):
    """Inverse of `encode_keys_u8` on the buffer's device: -> (keys
    i32[B, N], counts i32[B], dims i32[B, 3]). Padding rows hold each
    item's last real key (consumers mask rows >= counts). The pad records
    (position n) are dropped, as JAX's `mode="drop"` scatter drops them:
    they land in a spare column that is cut off. No host sync."""
    off = batch * n
    d = torch.zeros((batch, n + 1), dtype=torch.int32, device=buf.device)
    d[:, :n] = buf[:off].reshape(batch, n)
    rec = _as_i32(buf[off: off + escape_capacity * 12]).reshape(
        escape_capacity, 3)
    off += escape_capacity * 12
    tail = _as_i32(buf[off: off + batch * 16]).reshape(batch, 4)
    item, pos = rec[:, 0].long(), rec[:, 1].long()
    keep = (item >= 0) & (item < batch) & (pos >= 0) & (pos < n)
    d.index_put_((torch.where(keep, item, 0), torch.where(keep, pos, n)),
                 rec[:, 2])
    keys = torch.cumsum(d[:, :n], dim=1).to(torch.int32)
    return keys, tail[:, 0].clone(), tail[:, 1:4].clone()


# from mask3d_tpu/data/transfer.py:180 decode_pyramid_u8
def decode_pyramid_u8(buf: torch.Tensor, batch: int, n_cap: int,
                      level_capacities: Sequence[int],
                      escape_capacity: int = 4096,
                      coarse_escape_capacity: int = 1024):
    """Inverse of `encode_pyramid_u8`: -> ((keys, counts, dims) of the base
    level, [(keys, raw_counts, dims)] per coarse level)."""
    sizes = pyramid_buf_sizes(batch, n_cap, level_capacities,
                              escape_capacity, coarse_escape_capacity)
    if buf.numel() != sum(sizes):
        raise ValueError(f"buffer of {buf.numel()} bytes; the layout of B="
                         f"{batch}, N={n_cap}, capacities "
                         f"{list(level_capacities)} takes {sum(sizes)}")
    base = decode_keys_u8(buf[:sizes[0]], batch, n_cap, escape_capacity)
    off = sizes[0]
    coarse = []
    for cap, size in zip(level_capacities, sizes[1:]):
        coarse.append(decode_keys_u8(buf[off: off + size], batch, int(cap),
                                     coarse_escape_capacity))
        off += size
    return base, coarse
