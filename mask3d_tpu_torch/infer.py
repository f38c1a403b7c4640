"""Inference entry: one collated batch through the sparse context and the
model, under `torch.inference_mode()`."""

from __future__ import annotations

from typing import List, Tuple

import torch

from mask3d_tpu_torch.data.batch import DeviceBatch
from mask3d_tpu_torch.device import resolve_device
from mask3d_tpu_torch.models.mask3d import Mask3D, Mask3DOutput
from mask3d_tpu_torch.sparse.context import build_sparse_batch


# from mask3d_tpu/train/loop.py:182 level_capacities
def level_capacities(cfg, n_points: int) -> List[int]:
    return [max(8, int(n_points * r)) for r in cfg.data.level_cap_ratios]


# from mask3d_tpu/train/loop.py:458-479 make_eval_step (forward half)
def infer(model: Mask3D, batch: DeviceBatch, cfg, aux_masks: bool = False,
          device="cuda") -> Tuple[Mask3DOutput, torch.Tensor]:
    """Returns (model output, overflow) where `overflow` is a bool tensor:
    some pyramid level of some item exceeded its capacity."""
    dev = resolve_device(device)
    batch = batch.to(dev)
    with torch.inference_mode():
        sb = build_sparse_batch(
            batch.coords, batch.counts, batch.dims,
            level_capacities(cfg, batch.capacity), batch.grid_dims)
        out = model(sb, batch.feats, batch.coords.float(), batch.grid_dims,
                    aux_masks=aux_masks)
        return out, sb.any_overflow()
