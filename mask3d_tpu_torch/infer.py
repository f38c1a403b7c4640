"""Inference entry: one collated batch through the sparse context and the
model, under `torch.inference_mode()`.

`infer` takes a collated batch. `encode_batch` + `infer_u8` are the JAX
bench's form of the same forward (`bench.py:246-285`): the host encodes the
batch's keys and its coarse pyramid into one uint8 buffer
(`data/transfer.py`), and the device decodes it, rebuilds the coordinates,
takes constant-ones features and builds the sparse batch from the
precomputed levels (dense backbone only)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from mask3d_tpu_torch.data import transfer
from mask3d_tpu_torch.data.batch import DeviceBatch
from mask3d_tpu_torch.device import resolve_device
from mask3d_tpu_torch.models.mask3d import Mask3D, Mask3DOutput
from mask3d_tpu_torch.sparse.context import build_sparse_batch
from mask3d_tpu_torch.sparse.core import unpack_keys


# from mask3d_tpu/train/loop.py:182 level_capacities
def level_capacities(cfg, n_points: int) -> List[int]:
    return [max(8, int(n_points * r)) for r in cfg.data.level_cap_ratios]


# from mask3d_tpu/train/loop.py:154 _sb_kwargs
def _sb_kwargs(cfg):
    """build_sparse_batch options per backbone impl: the dense path reads
    the occupancy grids only; the bricked one needs no kernel map either,
    but its pooled pyramid runs in row space and reads the PoolMaps'
    parents; the gather paths read kernel maps and parents."""
    if cfg.model.backbone_impl == "dense":
        return dict(build_block_maps=False, conv1_kernel_size=None,
                    build_pool_parents=False)
    if cfg.model.backbone_impl == "bricked":
        return dict(build_block_maps=False, conv1_kernel_size=None,
                    build_pool_parents=True)
    return dict(build_block_maps=True,
                conv1_kernel_size=cfg.model.conv1_kernel_size,
                build_pool_parents=True)


# from mask3d_tpu/train/loop.py:188 init_state (its unit_features check,
# :190-205)
def check_unit_features(cfg, batch: DeviceBatch):
    """`model.unit_features` promises constant unit input features (the
    dense stem then reads the occupancy grid): raise where the batch's
    valid feature rows are not all ones, from the collator's host-side
    `feats_all_ones` (a batch built by hand is checked here)."""
    if not cfg.model.unit_features:
        return
    ones = batch.feats_all_ones
    if ones is None:
        feats = torch.as_tensor(batch.feats)
        counts = torch.as_tensor(batch.counts, device=feats.device)
        valid = torch.arange(feats.shape[1], device=feats.device)[None] \
            < counts[:, None]
        ones = bool((feats[valid] == 1.0).all())
    if cfg.data.in_channels != 1 or not ones:
        raise ValueError(
            "model.unit_features=true but the batch carries non-constant "
            "features: the dense stem would discard them; unset "
            "unit_features for real feature channels")


# from mask3d_tpu/train/loop.py:458-479 make_eval_step (forward half)
def infer(model: Mask3D, batch: DeviceBatch, cfg, aux_masks: bool = False,
          device="cuda", generator=None) -> Tuple[Mask3DOutput, torch.Tensor]:
    """Returns (model output, overflow) where `overflow` is a bool tensor:
    some pyramid level of some item exceeded its capacity, or (bricked)
    the scene has more occupied level-0 bricks than `model.brick_capacity`.
    A batch whose `grid_dims` is None runs the gather impls on the sorted
    pyramid. `generator` (a `torch.Generator` on `device`) draws the
    queries of a `random_queries` / `random_query_both` model, which
    raises without one."""
    _check_impl(model, cfg)
    check_unit_features(cfg, batch)
    dev = resolve_device(device)
    batch = batch.to(dev)
    with torch.inference_mode():
        sb = build_sparse_batch(
            batch.coords, batch.counts, batch.dims,
            level_capacities(cfg, batch.capacity), batch.grid_dims,
            **_sb_kwargs(cfg))
        out = model(sb, batch.feats, batch.coords.float(), batch.grid_dims,
                    aux_masks=aux_masks, generator=generator)
        return out, sb.any_overflow()


def _check_impl(model: Mask3D, cfg):
    if model.backbone.impl != cfg.model.backbone_impl:
        raise ValueError(f"model built for backbone_impl="
                         f"{model.backbone.impl!r}, cfg says "
                         f"{cfg.model.backbone_impl!r}")


# from bench.py:279 host_args
def encode_batch(batch: DeviceBatch, cfg, use_native: bool = True
                 ) -> Tuple[np.ndarray, int]:
    """The host half of the bench's forward: the batch's sorted voxel keys
    and its coarse pyramid's keys at `level_capacities` in one uint8
    buffer (`transfer.encode_pyramid_u8`). Returns (buffer, n_cap), n_cap
    the batch's row capacity."""
    n_cap = int(batch.coords.shape[1])
    buf = transfer.encode_pyramid_u8(
        torch.as_tensor(batch.coords).cpu().numpy(),
        torch.as_tensor(batch.counts).cpu().numpy(),
        torch.as_tensor(batch.dims).cpu().numpy(),
        level_capacities(cfg, n_cap), use_native=use_native)
    return buf, n_cap


# from bench.py:258 infer
def infer_u8(model: Mask3D, buf, cfg, batch_size: int, n_cap: int,
             grid_dims, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device half of the bench's forward on `encode_batch`'s buffer
    (numpy, or a uint8 tensor): the copy to `device` ("cuda" unless given;
    from pinned memory, no host sync), the decode, `unpack_keys` with the
    rows at or past each count zeroed, constant-ones features, the sparse
    batch from the precomputed levels, and the model with
    `aux_masks=False`. `grid_dims` is the run's static bucket (every
    batch's per-level grid dims fit in it). Returns (pred_class,
    pred_masks). Runs the dense backbone only: the precomputed levels carry
    no pool parents."""
    _check_impl(model, cfg)
    if cfg.model.backbone_impl != "dense":
        raise ValueError(
            f"infer_u8 runs the dense backbone only; backbone_impl="
            f"{cfg.model.backbone_impl!r} reads pool parents, which the "
            f"precomputed levels do not carry")
    if cfg.data.in_channels != 1:
        raise ValueError("infer_u8 feeds constant-ones features: "
                         "data.in_channels must be 1")
    dev = resolve_device("cuda" if device is None else device)
    caps = level_capacities(cfg, n_cap)
    with torch.inference_mode():
        u8 = transfer.to_device(buf, dev)
        (keys, counts, dims), coarse = transfer.decode_pyramid_u8(
            u8, batch_size, n_cap, caps)
        rows = torch.arange(n_cap, dtype=torch.int32, device=dev)[None]
        coords = torch.where((rows < counts[:, None])[..., None],
                             unpack_keys(keys, dims), 0).to(torch.int32)
        feats = torch.ones(keys.shape + (1,), dtype=torch.float32,
                           device=dev)
        sb = build_sparse_batch(coords, counts, dims, caps, grid_dims,
                                precomputed_levels=coarse, **_sb_kwargs(cfg))
        out = model(sb, feats, coords.float(), grid_dims, aux_masks=False)
        return out.pred_class, out.pred_masks


# from mask3d_tpu/train/loop.py:458 make_eval_step
def make_eval_step(cfg, model: Mask3D, criterion, device="cuda"):
    """The eval step: `infer(aux_masks=True)`, then the criterion over
    every mask-module output on the targets shifted by
    `data.prediction_label_offset`, and `batch_overflow` (1 where a pyramid
    level of some item overflowed its capacity, `loop.py:241`). Returns
    (pred_class, pred_masks, losses) on `device`; the criterion's matching
    is the one host round trip.

    A model whose queries are drawn at random cannot be scored: the JAX
    package's eval step passes no rng for the draws
    (`mask3d_tpu/train/loop.py:468-471`), so the step raises a ValueError
    for `random_queries` / `random_query_both` (`infer(generator=)` runs
    such a forward)."""
    dev = resolve_device(device)

    def eval_step(batch: DeviceBatch):
        if model.query_mode in ("random", "random_both"):
            opt = ("random_queries" if model.query_mode == "random"
                   else "random_query_both")
            raise ValueError(
                f"model.{opt}=true draws the queries at random, and the "
                f"eval step has no generator for them (the JAX package's "
                f"eval step passes no rng either): score a model with FPS "
                f"or learned queries, or call infer(generator=)")
        batch = batch.to(dev)
        out, overflow = infer(model, batch, cfg, aux_masks=True, device=dev)
        with torch.inference_mode():
            targets = batch.target.with_label_offset(
                cfg.data.prediction_label_offset)
            # == sb.levels[0].valid: the rows below each item's count
            point_valid = torch.arange(batch.capacity, device=dev)[None] \
                < batch.counts[:, None]
            losses = criterion(out, targets, point_valid)
            losses["batch_overflow"] = overflow.to(torch.int32)
        return out.pred_class, out.pred_masks, losses

    return eval_step
