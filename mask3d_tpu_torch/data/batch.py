"""Batch containers: capacity-padded arrays, one leading batch axis.

# from mask3d_tpu/data/batch.py:26-86 (Targets, DeviceBatch, HostBatch)
The collator fills them with numpy arrays; `DeviceBatch.to` moves every
array onto a torch device. `grid_dims` stays a static tuple.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from mask3d_tpu_torch.device import resolve_device


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x)).to(device)


@dataclasses.dataclass
class Targets:
    """Instance-segmentation targets, padded to I instances per item."""

    labels: Any  # i32[B, I] semantic label id per instance
    masks: Any  # bool[B, I, N] per-instance point masks
    valid: Any  # bool[B, I]
    point_instance_ids: Any  # i32[B, N] (0 = no instance)

    def to(self, device) -> "Targets":
        return Targets(*(_to(getattr(self, f.name), device)
                         for f in dataclasses.fields(self)))

    # from mask3d_tpu/data/batch.py:38 with_label_offset
    def with_label_offset(self, offset: int) -> "Targets":
        """Shift the valid instances' labels by `-offset` (tensors); the
        padding rows stay untouched."""
        return dataclasses.replace(self, labels=torch.where(
            self.valid, self.labels - offset, self.labels))


@dataclasses.dataclass
class DeviceBatch:
    """Static-shape model input, ready for `build_sparse_batch`."""

    coords: Any  # i32[B, N, 3] voxel coords, per-item sorted, padded
    counts: Any  # i32[B]
    dims: Any  # i32[B, 3]
    feats: Any  # f32[B, N, F]
    target: Targets
    # Static per-level dense-grid dims (level-0 multiples of 8, coarser
    # levels the ceil-div halving chain).
    grid_dims: tuple = None
    # Host-side fact for `model.unit_features`: every valid feature row is
    # all ones (None: not known, e.g. a batch built by hand).
    feats_all_ones: Optional[bool] = None

    @property
    def capacity(self) -> int:
        return self.coords.shape[1]

    def to(self, device="cuda") -> "DeviceBatch":
        dev = resolve_device(device)
        return DeviceBatch(
            coords=_to(self.coords, dev), counts=_to(self.counts, dev),
            dims=_to(self.dims, dev), feats=_to(self.feats, dev),
            target=self.target.to(dev), grid_dims=self.grid_dims,
            feats_all_ones=self.feats_all_ones,
        )


@dataclasses.dataclass
class HostBatch:
    """DeviceBatch plus host-only metadata."""

    device: DeviceBatch
    scenes: List[str]
    # Original (pre-augmentation) coordinates, features and labels per
    # padded row: DBSCAN input and the .las export's.
    raw_coords: np.ndarray  # f32[B, N, 3]
    raw_feats: np.ndarray  # f32[B, N, F]
    raw_labels: Optional[np.ndarray]  # i32[B, N, 2] (semantic, instance)
