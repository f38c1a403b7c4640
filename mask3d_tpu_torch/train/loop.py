"""The train step and its state: the JAX package's `train/loop.py`.

One step builds the sparse context, runs the model in train mode (sampled
memories), matches and computes every loss (the criterion's one host
round trip), back-propagates and applies AdamW. The optimizer and the
schedulers mirror the JAX package's optax ones: AdamW lr 1e-4, weight
decay 0.01, per-step exponential decay gamma 0.99999 by default.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from mask3d_tpu_torch.data.batch import DeviceBatch
from mask3d_tpu_torch.device import resolve_device
from mask3d_tpu_torch.infer import _sb_kwargs, check_unit_features, \
    level_capacities
from mask3d_tpu_torch.models.mask3d import Mask3D, build_model
from mask3d_tpu_torch.sparse.context import build_sparse_batch
from mask3d_tpu_torch.train.criterion import SetCriterion


# from mask3d_tpu/train/loop.py:33 TrainState
@dataclasses.dataclass
class TrainState:
    """The model (in train mode), its optimizer and lr schedule, the
    generator of the sampled memories (on the model's device) and the
    count of steps taken (skipped ones included)."""

    model: Mask3D
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    generator: torch.Generator
    step: int = 0


def _cosine_onecycle(transition_steps: int, peak: float, pct_start=0.3,
                     div_factor=25.0, final_div_factor=1e4):
    """`optax.cosine_onecycle_schedule` written out: from peak/div_factor
    up to peak over the first pct_start of the steps, then down to
    peak/(div_factor * final_div_factor), both halves cosine; constant
    after."""
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    values = (peak / div_factor, peak,
              peak / (div_factor * final_div_factor))

    def schedule(t):
        for i in range(2):
            if bounds[i] <= t < bounds[i + 1]:
                pct = (t - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                    + 1)
        return values[-1] if t >= bounds[-1] else 0.0

    return schedule


def lr_schedule(cfg) -> Callable[[int], float]:
    """The learning rate of update t (0 for the first) under
    `cfg.scheduler`."""
    lr, sch = cfg.optimizer.lr, cfg.scheduler
    if sch.name == "exponentiallr":
        return lambda t: lr * sch.gamma ** t
    if sch.name == "onecyclelr":
        steps = max(sch.steps_per_epoch, 1) * cfg.trainer.max_epochs
        if steps <= 0:
            raise ValueError("onecyclelr needs trainer.max_epochs > 0")
        return _cosine_onecycle(steps, sch.max_lr or lr)
    if sch.name in ("steplr", "lambdalr"):
        # Both reference groups are torch StepLR with the tick in epochs:
        # a staircase over step_size * steps_per_epoch updates (constant
        # at the shipped step_size 99999).
        boundary = sch.step_size * max(sch.steps_per_epoch, 1)
        if boundary <= 0 or sch.gamma == 0:
            return lambda t: lr
        return lambda t: lr * sch.gamma ** (t // boundary)
    return lambda t: lr  # unknown name: constant lr


# from mask3d_tpu/train/loop.py:103 make_optimizer
def make_optimizer(cfg, model: Mask3D):
    """(optimizer, scheduler) of `cfg.optimizer` and `cfg.scheduler`: AdamW
    (decoupled decay lr * wd * p on every trained parameter, as
    `optax.adamw` with no mask) or Adam, and a per-update LambdaLR.
    `general.freeze_backbone` takes the backbone out: no gradient, no
    update, no decay (`optax.set_to_zero` on it in the JAX package)."""
    if cfg.general.freeze_backbone:
        model.backbone.requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]
    lr = cfg.optimizer.lr
    if cfg.optimizer.name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr,
                                weight_decay=cfg.optimizer.weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=lr)
    schedule = lr_schedule(cfg)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: schedule(t) / lr)
    return opt, scheduler


# from mask3d_tpu/train/loop.py:188 init_state
def init_state(cfg, example: Optional[DeviceBatch] = None,
               seed: Optional[int] = None, device="cuda") -> TrainState:
    """The model of `cfg` in train mode (random weights from the seed,
    `general.seed` by default), its optimizer, schedule and generator.
    `example` is checked for `model.unit_features`."""
    if example is not None:
        check_unit_features(cfg, example)
    dev = resolve_device(device)
    seed = cfg.general.seed if seed is None else seed
    model = build_model(cfg, device=dev, seed=seed).train()
    opt, scheduler = make_optimizer(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return TrainState(model, opt, scheduler, gen)


def configure_torch(deterministic: bool):
    """The card's numerics for a run: float32 convs and matmuls in full
    float32 (cuDNN's default is TF32), and with `deterministic`
    (`trainer.deterministic`) deterministic algorithms, with the cuBLAS
    workspace setting they need (read when cuBLAS is first used, so call
    this before the first CUDA op)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(deterministic)


def split_batch(batch: DeviceBatch, k: int):
    """The batch as k micro-batches of B/k items (views)."""
    b = batch.coords.shape[0]
    if b % k:
        raise ValueError(f"batch of {b} items does not split into "
                         f"grad_accum_steps={k} micro-batches")
    m = b // k

    def part(i):
        sl = slice(i * m, (i + 1) * m)
        target = dataclasses.replace(batch.target, **{
            f.name: getattr(batch.target, f.name)[sl]
            for f in dataclasses.fields(batch.target)})
        return dataclasses.replace(
            batch, coords=batch.coords[sl], counts=batch.counts[sl],
            dims=batch.dims[sl], feats=batch.feats[sl], target=target)

    return [part(i) for i in range(k)]


# from mask3d_tpu/train/loop.py:250 make_train_step
def make_train_step(cfg, criterion: SetCriterion, device="cuda"):
    """`train_step(state, batch) -> (losses, preds)`: one optimizer step on
    `state` in place. `losses` maps every criterion key, "loss" and
    "batch_overflow" to a detached device scalar; `preds` is the final
    (pred_class, pred_masks), detached, with `trainer.train_split_metrics`,
    else None.

    With `trainer.grad_accum_steps` K > 1 the batch runs as K micro-batches
    of B/K items whose gradients are summed (the mask and dice losses are
    sums over items) with the CE weighted 1/K in each total (CE is a batch
    mean); the reported CE entries are the mean over micro-batches, the
    other entries sums. Where a pyramid level overflowed its capacity the
    update is skipped: parameters, optimizer moments and the schedule stay,
    the step count and the generator advance."""
    accum = max(1, int(cfg.trainer.grad_accum_steps))
    return_preds = bool(cfg.trainer.train_split_metrics)
    dev = resolve_device(device)

    def micro_step(state: TrainState, batch: DeviceBatch, ce_scale: float):
        sb = build_sparse_batch(
            batch.coords, batch.counts, batch.dims,
            level_capacities(cfg, batch.capacity), batch.grid_dims,
            **_sb_kwargs(cfg))
        targets = batch.target.with_label_offset(
            cfg.data.prediction_label_offset)
        out = state.model(sb, batch.feats, batch.coords.float(),
                          batch.grid_dims, aux_masks=True,
                          generator=state.generator)
        losses = criterion(out, targets, sb.levels[0].valid,
                           ce_scale=ce_scale)
        losses["loss"].backward()  # sums into .grad over micro-batches
        losses = {k: v.detach() for k, v in losses.items()}
        losses["batch_overflow"] = sb.any_overflow().to(torch.int32)
        preds = ((out.pred_class.detach(), out.pred_masks.detach())
                 if return_preds else None)
        return losses, preds

    def train_step(state: TrainState, batch: DeviceBatch
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[tuple]]:
        batch = batch.to(dev)
        check_unit_features(cfg, batch)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if accum == 1:
            losses, preds = micro_step(state, batch, 1.0)
        else:
            parts = [micro_step(state, mb, 1.0 / accum)
                     for mb in split_batch(batch, accum)]
            losses = {k: sum(p[0][k] for p in parts) for k in parts[0][0]}
            losses = {k: v / accum if "_ce" in k else v
                      for k, v in losses.items()}
            preds = None
            if return_preds:
                preds = tuple(torch.cat([p[1][i] for p in parts])
                              for i in range(2))
        # One host read of the overflow flag a step, to skip the update
        # (the JAX step selects the old state on the device instead).
        if not bool(losses["batch_overflow"] > 0):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        return losses, preds

    return train_step
