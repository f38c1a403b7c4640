"""Voxelizing collation: item dicts -> static-shape padded batch.

The numpy logic of the JAX package's collator, copied so the port imports
nothing of it: float->int truncation, per-item shift to non-negative,
duplicate-voxel removal keeping the first sorted occurrence, sort by
linearized key, padding to a bucketed capacity, and per-instance target
masks padded to a bucketed instance count. The C++ voxelizer fast path is
not ported yet; `voxelize_item` is the numpy path, which gives the same
output.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from mask3d_tpu_torch.data.batch import DeviceBatch, HostBatch, Targets

INT32_MAX = 2**31 - 1


# from mask3d_tpu/data/collate.py:46 bucket_size
def bucket_size(n: int, buckets: Optional[Sequence[int]] = None,
                multiple: int = 512) -> int:
    """Round capacity up to a bucket so the set of shapes stays small."""
    if buckets:
        for b in buckets:
            if n <= b:
                return int(b)
        return int(buckets[-1])
    return max(multiple, int(-(-n // multiple)) * multiple)


# from mask3d_tpu/data/collate.py:57 voxelize_item (numpy path, :75-82)
def voxelize_item(coordinates: np.ndarray):
    """Truncate, shift to non-negative, dedup, sort by linearized key.

    Returns (coords i32[n,3] sorted-unique, keep_idx into the input rows,
    dims i32[3]).
    """
    ci = coordinates.astype(np.int32)  # trunc-toward-zero like torch .int()
    ci = ci - ci.min(axis=0)
    uniq, keep = np.unique(ci, axis=0, return_index=True)
    dims = uniq.max(axis=0) + 1 if len(uniq) else np.ones(3, np.int32)
    assert int(dims[0]) * int(dims[1]) * int(dims[2]) < INT32_MAX, (
        "voxel grid too large for int32 keys; coarsen the rasterization"
    )
    return uniq.astype(np.int32), keep, dims.astype(np.int32)


# from mask3d_tpu/data/collate.py:85 _gather_rows
def _gather_rows(dst: np.ndarray, src, idx: np.ndarray):
    """Gather src rows by idx into dst, casting/column-slicing if needed."""
    src = np.asarray(src)
    if src.dtype == dst.dtype and src.shape[1:] == dst.shape[1:]:
        np.take(src, idx, axis=0, out=dst)
    else:
        g = src[idx]
        if g.shape[1:] != dst.shape[1:]:
            g = g[..., : dst.shape[-1]]
        dst[...] = g


# from mask3d_tpu/data/collate.py:98 _item_target_meta
def _item_target_meta(labels: np.ndarray, filter_out_classes,
                      filter_out_instance_ids) -> dict:
    """Instance-target metadata from point labels [n, 2] (masks are
    scattered later, straight into the padded batch buffer).

    Returns dict with: `labels` i32[k] kept-instance semantic labels,
    `inv` i64[n] point -> uniq-instance index, `keep_flags` bool[n_uniq],
    `remap` i64[n_uniq] uniq index -> kept rank (arbitrary for dropped).
    """
    inst_ids = labels[:, 1]
    n = len(inst_ids)
    max_id = int(inst_ids.max()) if n else 0
    min_id = int(inst_ids.min()) if n else 0
    if n and min_id >= -1 and max_id - min_id < 4 * n + 1024:
        # Dense-id path: first occurrence per id without a sort.
        ids0 = inst_ids - min_id
        span = max_id - min_id + 1
        first_of = np.full(span, n, np.int64)
        # reversed assignment: the last write wins, which is the first
        # occurrence of each id.
        first_of[ids0[::-1]] = np.arange(n - 1, -1, -1)
        present = first_of < n
        uniq = np.flatnonzero(present) + min_id
        first = first_of[present]
        rank = np.cumsum(present) - 1
        inv = rank[ids0]
    else:
        uniq, first, inv = np.unique(
            inst_ids, return_index=True, return_inverse=True
        )
    inst_labels = labels[first, 0]
    keep = ~(
        np.isin(uniq, np.asarray(list(filter_out_instance_ids)))
        | np.isin(inst_labels, np.asarray(list(filter_out_classes)))
    )
    remap = np.cumsum(keep) - 1
    return dict(labels=inst_labels[keep].astype(np.int32), inv=inv,
                keep_flags=keep, remap=remap)


# from mask3d_tpu/data/collate.py:163 VoxelizeCollate (no crops, serial)
class VoxelizeCollate:
    """Collate a list of dataset item dicts into a numpy HostBatch.

    Items carry "coordinates" f[n,3], "features" f[n,F], "labels" i[n,2],
    "raw_coordinates" and "scene".
    """

    def __init__(
        self,
        filter_out_classes: Sequence[int] = (),
        filter_out_instance_ids: Sequence[int] = (-1, 0),
        point_buckets: Optional[Sequence[int]] = None,
        point_bucket_multiple: int = 512,
        instance_bucket_multiple: int = 8,
        min_grid_dims: Optional[Sequence[int]] = None,
        grid_dims_cap: Optional[Sequence[int]] = None,
        build_targets: bool = True,
    ):
        self.filter_out_classes = tuple(filter_out_classes)
        self.filter_out_instance_ids = tuple(filter_out_instance_ids)
        self.point_buckets = point_buckets
        self.point_bucket_multiple = point_bucket_multiple
        self.instance_bucket_multiple = instance_bucket_multiple
        # Level-0 grid floor: batches whose dims fit share one grid shape.
        self.min_grid_dims = (
            tuple(int(d) for d in min_grid_dims) if min_grid_dims else None
        )
        # Level-0 grid pin (floor and ceiling): larger items are
        # center-cropped to fit. Rounded up to the multiple-of-8 bucket.
        self.grid_dims_cap = (
            tuple(int(-(-int(d) // 8) * 8) for d in grid_dims_cap)
            if grid_dims_cap else None
        )
        # Inference mode: no target masks; instance capacity 0.
        self.build_targets = bool(build_targets)

    # from mask3d_tpu/data/collate.py:230 _crop_to_cap
    def _crop_to_cap(self, coords, keep, dims):
        """Center-crop a voxelized item into the pinned grid window (the
        filter and the per-axis shift keep the lexicographic sort)."""
        cap = np.asarray(self.grid_dims_cap, np.int64)
        dims64 = np.asarray(dims, np.int64)
        if np.all(dims64 <= cap):
            return coords, keep, dims
        start = np.maximum((dims64 - cap) // 2, 0)
        end = start + np.minimum(dims64, cap)
        m = np.all((coords >= start) & (coords < end), axis=1)
        coords = coords[m] - start.astype(np.int32)
        keep = keep[m]
        new_dims = (
            coords.max(axis=0) + 1 if len(coords) else np.ones(3, np.int64)
        )
        return coords, keep, new_dims.astype(np.int32)

    def _prepare_item(self, item: dict) -> dict:
        coords, keep, dims = voxelize_item(item["coordinates"])
        if self.grid_dims_cap is not None:
            coords, keep, dims = self._crop_to_cap(coords, keep, dims)
        if not self.build_targets:
            return dict(coords=coords, keep=keep, dims=dims, labels=None,
                        meta=None, scene=item["scene"], src=item)
        labels = np.asarray(item["labels"])[keep].astype(np.int32)
        meta = _item_target_meta(
            labels, self.filter_out_classes, self.filter_out_instance_ids
        )
        return dict(coords=coords, keep=keep, dims=dims, labels=labels,
                    meta=meta, scene=item["scene"], src=item)

    def __call__(self, batch: List[dict]) -> HostBatch:
        b = len(batch)
        per_item = [self._prepare_item(it) for it in batch]

        n_cap = bucket_size(
            max(len(it["coords"]) for it in per_item),
            self.point_buckets, self.point_bucket_multiple,
        )
        # from mask3d_tpu/data/collate.py:316-331: level-0 dims bucketed to
        # multiples of 8, coarser levels the ceil-div chain d -> ((d-1)>>1)+1
        max_d0 = np.max(
            np.stack([it["dims"] for it in per_item]), axis=0
        ).astype(np.int64)
        d0 = tuple(int(-(-d // 8) * 8) for d in max_d0)
        if self.min_grid_dims is not None:
            d0 = tuple(max(d, m) for d, m in zip(d0, self.min_grid_dims))
        if self.grid_dims_cap is not None:
            d0 = self.grid_dims_cap
        grid_dims = [d0]
        for _ in range(4):
            grid_dims.append(
                tuple(((d - 1) >> 1) + 1 for d in grid_dims[-1])
            )
        grid_dims = tuple(grid_dims)
        i_cap = 0 if not self.build_targets else max(
            self.instance_bucket_multiple,
            -(-max(1, max(len(it["meta"]["labels"]) for it in per_item))
              // self.instance_bucket_multiple)
            * self.instance_bucket_multiple,
        )

        f_dim = int(np.asarray(batch[0]["features"]).shape[-1])
        coords = np.empty((b, n_cap, 3), np.int32)
        counts = np.zeros((b,), np.int32)
        dims = np.ones((b, 3), np.int32)
        feats = np.empty((b, n_cap, f_dim), np.float32)
        t_labels = np.zeros((b, i_cap), np.int32)
        t_masks = np.empty((b, i_cap, n_cap), bool)
        t_valid = np.zeros((b, i_cap), bool)
        pt_inst = np.empty((b, n_cap), np.int32)
        raw_coords = np.empty((b, n_cap, 3), np.float32)

        for i, it in enumerate(per_item):
            src, keep = it["src"], it["keep"]
            n = len(it["coords"])
            assert n <= n_cap, f"item {it['scene']} exceeds point bucket"
            coords[i, :n] = it["coords"]
            coords[i, n:] = 0
            counts[i] = n
            dims[i] = it["dims"]
            _gather_rows(feats[i, :n], src["features"], keep)
            feats[i, n:] = 0
            _gather_rows(raw_coords[i, :n], src["raw_coordinates"], keep)
            raw_coords[i, n:] = 0
            if not self.build_targets:
                pt_inst[i] = 0
                continue
            pt_inst[i, :n] = it["labels"][:, 1]
            pt_inst[i, n:] = 0
            m = it["meta"]
            k = len(m["labels"])
            assert k <= i_cap, f"item {it['scene']} exceeds instance bucket"
            t_masks[i, k:] = False
            if k:
                t_labels[i, :k] = m["labels"]
                t_valid[i, :k] = True
                tm = t_masks[i, :k]
                tm[:] = False
                cols = np.flatnonzero(m["keep_flags"][m["inv"]])
                tm[m["remap"][m["inv"][cols]], cols] = True

        dev = DeviceBatch(
            coords=coords, counts=counts, dims=dims, feats=feats,
            target=Targets(labels=t_labels, masks=t_masks, valid=t_valid,
                           point_instance_ids=pt_inst),
            grid_dims=grid_dims,
            feats_all_ones=all(bool(np.all(feats[i, :n] == 1.0))
                               for i, n in enumerate(counts)),
        )
        return HostBatch(device=dev, scenes=[it["scene"] for it in per_item],
                         raw_coords=raw_coords)


def collate(items: List[dict], device="cuda", **collate_kwargs) -> HostBatch:
    """Entry point: collate items with `VoxelizeCollate(**collate_kwargs)`
    and move the model inputs and targets onto `device`."""
    host = VoxelizeCollate(**collate_kwargs)(items)
    host.device = host.device.to(device)
    return host
