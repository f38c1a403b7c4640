"""Voxelizing collation: item dicts -> static-shape padded batch.

A copy of the JAX package's collator (mask3d_tpu/data/collate.py:163-420):
float->int truncation, per-item shift to non-negative, duplicate-voxel
removal keeping the first sorted occurrence, sort by linearized key (the C++
voxelizer of `native.py`, or its numpy path where the caller asks), padding
to a bucketed capacity, and per-instance target masks padded to a bucketed
instance count. Items are voxelized and filled in a persistent pool of 16
threads (the C++ voxelizer and numpy release the GIL); on a single-core
host they run serially. Nothing here touches CUDA: `collate` moves the
finished batch to the device on the caller's thread.
"""

from __future__ import annotations

import os
import threading
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


# from mask3d_tpu/data/collate.py:57 voxelize_item
def voxelize_item(coordinates: np.ndarray, use_native: bool = True):
    """Truncate, shift to non-negative, dedup, sort by linearized key.

    Returns (coords i32[n,3] sorted-unique, keep_idx into the input rows,
    dims i32[3]). The C++ voxelizer (`native.voxelize_native`) runs unless
    the caller passes `use_native=False`; a failed build raises.
    """
    if use_native and len(coordinates):
        from mask3d_tpu_torch.native import voxelize_native

        uniq, keep, dims = voxelize_native(coordinates)
        assert int(dims[0]) * int(dims[1]) * int(dims[2]) < INT32_MAX, (
            "voxel grid too large for int32 keys; coarsen the rasterization"
        )
        return uniq, keep, dims
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


# from mask3d_tpu/data/collate.py:141 build_item_target
def build_item_target(labels: np.ndarray, filter_out_classes,
                      filter_out_instance_ids):
    """Per-instance (label, mask) pairs from point labels [n, 2]
    (`create_batch_target`, `mask3d/datasets/utils.py:286-329`): index 0 =
    semantic label, index 1 = instance id; instances whose id or semantic
    class is filtered are dropped. Returns (labels, list of bool[n] masks,
    instance ids)."""
    inst_ids = labels[:, 1]
    n = len(inst_ids)
    m = _item_target_meta(labels, filter_out_classes,
                          filter_out_instance_ids)
    masks = np.zeros((len(m["labels"]), n), bool)
    cols = np.flatnonzero(m["keep_flags"][m["inv"]])
    masks[m["remap"][m["inv"][cols]], cols] = True
    return [int(v) for v in m["labels"]], list(masks), inst_ids


# from mask3d_tpu/data/collate.py:163 VoxelizeCollate
class VoxelizeCollate:
    """Collate a list of dataset item dicts into a HostBatch.

    Items follow the dataset contract (`data/datasets.py`): dict with
    "coordinates" f[n,3], "features" f[n,F], "labels" i[n,2],
    "raw_coordinates", "raw_features", "raw_labels", "scene".
    """

    def __init__(
        self,
        mode: str = "test",
        filter_out_classes: Sequence[int] = (),
        filter_out_instance_ids: Sequence[int] = (-1, 0),
        prediction_label_offset: int = 0,
        point_buckets: Optional[Sequence[int]] = None,
        point_bucket_multiple: int = 512,
        instance_bucket_multiple: int = 8,
        num_queries: Optional[int] = None,
        min_grid_dims: Optional[Sequence[int]] = None,
        grid_dims_cap: Optional[Sequence[int]] = None,
        small_crops: bool = False,
        very_small_crops: bool = False,
        build_targets: bool = True,
    ):
        self.mode = mode
        # Latent quadrant-crop options (reference VoxelizeCollate,
        # `mask3d/datasets/utils.py:34-43`): train batches are split into
        # xy-quadrant crops once (small) or twice (very small).
        self.small_crops = small_crops
        self.very_small_crops = very_small_crops
        self.filter_out_classes = tuple(filter_out_classes)
        self.filter_out_instance_ids = tuple(filter_out_instance_ids)
        self.prediction_label_offset = prediction_label_offset
        self.point_buckets = point_buckets
        self.point_bucket_multiple = point_bucket_multiple
        self.instance_bucket_multiple = instance_bucket_multiple
        self.num_queries = num_queries
        # Static level-0 grid floor: batches whose (bucketed) dims fit
        # under it all share one grid shape.
        self.min_grid_dims = (
            tuple(int(d) for d in min_grid_dims) if min_grid_dims else None
        )
        # Static level-0 grid pin (floor and ceiling): items whose voxel
        # bbox exceeds the cap are center-cropped to fit, so every batch
        # shares one grid shape. Rounded up to the multiple-of-8 bucket.
        self.grid_dims_cap = (
            tuple(int(-(-int(d) // 8) * 8) for d in grid_dims_cap)
            if grid_dims_cap else None
        )
        # Inference mode: skip the target masks and the raw feature/label
        # row gathers; targets come out with instance capacity 0.
        self.build_targets = bool(build_targets)

    # from mask3d_tpu/data/collate.py:230 _crop_to_cap
    def _crop_to_cap(self, coords, keep, dims):
        """Center-crop a voxelized item into the pinned grid window.

        Filtering + per-axis constant shift preserve the lexicographic
        (x, y, z) sort order `voxelize_item` established, so downstream
        key-linearization invariants hold unchanged.
        """
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

    _executor = None
    _executor_lock = threading.Lock()

    def _get_executor(self):
        # Persistent pool, one per process: a fresh ThreadPoolExecutor per
        # batch costs thread start-up on every batch. Double-checked lock:
        # concurrent callers must not race the lazy init (the loser's
        # executor would leak its threads for the life of the process).
        if VoxelizeCollate._executor is None:
            with VoxelizeCollate._executor_lock:
                if VoxelizeCollate._executor is None:
                    from concurrent.futures import ThreadPoolExecutor

                    VoxelizeCollate._executor = ThreadPoolExecutor(
                        max_workers=16
                    )
        return VoxelizeCollate._executor

    def __call__(self, batch: List[dict]) -> HostBatch:
        if "train" in self.mode and (self.small_crops
                                     or self.very_small_crops):
            from mask3d_tpu_torch.data.augment import make_crops

            batch = make_crops(batch)
            if self.very_small_crops:
                batch = make_crops(batch)
        b = len(batch)
        threaded = b > 1 and (os.cpu_count() or 1) > 1
        if threaded:
            # Per-item voxelization in threads (the native voxelizer and
            # numpy release the GIL). On a single-core host threads only
            # add overhead: run serially.
            per_item = list(self._get_executor().map(
                self._prepare_item, batch))
        else:
            per_item = [self._prepare_item(it) for it in batch]

        n_cap = bucket_size(
            max(len(it["coords"]) for it in per_item),
            self.point_buckets, self.point_bucket_multiple,
        )
        # Static per-level dense-grid dims: level-0 bucketed to multiples of
        # 8 per axis, coarser levels the ceil-div chain of the sparse key
        # arithmetic (coarse coord = fine >> 1, so extent d ->
        # ((d-1)>>1)+1). 8 instead of 16 because z is typically ~20 cells
        # (3 m rooms at 150 mm voxels): a 16-bucket would pad z to 32.
        max_d0 = np.max(
            np.stack([it["dims"] for it in per_item]), axis=0
        ).astype(np.int64)
        d0 = tuple(int(-(-d // 8) * 8) for d in max_d0)
        if self.min_grid_dims is not None:
            d0 = tuple(max(d, m) for d, m in zip(d0, self.min_grid_dims))
        if self.grid_dims_cap is not None:
            # Pin: cropped items are guaranteed to fit, so d0 is constant
            # across every batch of the run.
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
        # np.empty + per-item tail-zeroing instead of full np.zeros: the
        # batch buffers total ~35 MB at flagship capacity.
        coords = np.empty((b, n_cap, 3), np.int32)
        counts = np.zeros((b,), np.int32)
        dims = np.ones((b, 3), np.int32)
        feats = np.empty((b, n_cap, f_dim), np.float32)
        t_labels = np.zeros((b, i_cap), np.int32)
        t_masks = np.empty((b, i_cap, n_cap), bool)
        t_valid = np.zeros((b, i_cap), bool)
        pt_inst = np.empty((b, n_cap), np.int32)
        raw_coords = np.empty((b, n_cap, 3), np.float32)
        raw_feats = np.empty((b, n_cap, f_dim), np.float32)
        raw_labels = np.empty((b, n_cap, 2), np.int32)

        def fill(i: int, it: dict):
            # Row gathers land straight in the padded batch buffers
            # (`np.take(..., out=)`), without per-item intermediate arrays.
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
                raw_feats[i] = 0
                raw_labels[i] = 0
                return
            pt_inst[i, :n] = it["labels"][:, 1]
            pt_inst[i, n:] = 0
            _gather_rows(raw_feats[i, :n], src["raw_features"], keep)
            raw_feats[i, n:] = 0
            _gather_rows(raw_labels[i, :n], src["raw_labels"], keep)
            raw_labels[i, n:] = 0
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

        if threaded:
            list(self._get_executor().map(
                lambda a: fill(*a), enumerate(per_item)))
        else:
            for i, it in enumerate(per_item):
                fill(i, it)

        dev = DeviceBatch(
            coords=coords,
            counts=counts,
            dims=dims,
            feats=feats,
            target=Targets(
                labels=t_labels,
                masks=t_masks,
                valid=t_valid,
                point_instance_ids=pt_inst,
            ),
            grid_dims=grid_dims,
            feats_all_ones=all(bool(np.all(feats[i, :n] == 1.0))
                               for i, n in enumerate(counts)),
        )
        return HostBatch(
            device=dev,
            scenes=[it["scene"] for it in per_item],
            raw_coords=raw_coords,
            raw_feats=raw_feats,
            raw_labels=raw_labels,
        )


def collate(items: List[dict], device="cuda", **collate_kwargs) -> HostBatch:
    """Entry point: collate items with `VoxelizeCollate(**collate_kwargs)`
    and move the model inputs and targets onto `device`."""
    host = VoxelizeCollate(**collate_kwargs)(items)
    host.device = host.device.to(device)
    return host
