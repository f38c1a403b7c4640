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
import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as tdist

from mask3d_tpu_torch.data.batch import DeviceBatch
from mask3d_tpu_torch.device import resolve_device
from mask3d_tpu_torch.infer import _sb_kwargs, check_unit_features, \
    level_capacities
from mask3d_tpu_torch.models.mask3d import Mask3D, build_model
from mask3d_tpu_torch.parallel import comm
from mask3d_tpu_torch.parallel.mesh import active_mesh, sp_group
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


def grad_groups(model: Mask3D):
    """(parameters whose gradients are a rank's share under `sp`, every
    trained parameter): those that read a level's rows
    (`Mask3D.sp_partial_parameters`: the backbone, on its x-slabs or whole
    with this rank's chunk of its rows taken, the mask-feature head and the
    memories' projections) see this rank's rows only. The rest of the
    decoder, the heads and the query MLPs get complete gradients on every
    rank (`parallel/comm.py`'s entry Function sums the rank-partial work's
    gradients of the queries and `mask_embed`) and are not summed."""
    params = [p for p in model.parameters() if p.requires_grad]
    rows = {id(p) for p in model.sp_partial_parameters()}
    return [p for p in params if id(p) in rows], params


def sync_gradients(model: Mask3D, sp_axis=None):
    """Sum the gradients over the active mesh (no-op without one): the
    row-reading parameters' over `sp` when `sp_axis` shards the rows
    (`grad_groups`), then every parameter's over `dp`, each as one flat
    all-reduce in parameter order (summed, not averaged: the mask and dice
    losses are sums over items and the CE divides by the global weight
    sum)."""
    mesh = active_mesh()
    if mesh is None:
        return
    partial, params = grad_groups(model)
    group = sp_group(sp_axis)
    if group is not None:
        comm.flat_all_reduce([p.grad for p in partial], group, "sp_grads")
    if mesh.dp_group is not None:
        comm.flat_all_reduce([p.grad for p in params], mesh.dp_group,
                             "dp_grads")


def global_losses(losses: Dict[str, torch.Tensor]):
    """The global batch's losses from each dp rank's (no-op without dp
    ranks): every entry summed over `dp` (the CE entries are each rank's
    part of the global weighted mean), `batch_overflow` the MAX, so that
    every rank skips or updates together."""
    mesh = active_mesh()
    if mesh is None or mesh.dp_group is None:
        return losses
    keys = [k for k in losses if k != "batch_overflow"]
    vals = comm.all_reduce(torch.stack([losses[k].float() for k in keys]),
                           group=mesh.dp_group, name="losses")
    out = {k: v for k, v in zip(keys, vals.unbind())}
    if "batch_overflow" in losses:
        out["batch_overflow"] = comm.all_reduce(
            losses["batch_overflow"].clone(), tdist.ReduceOp.MAX,
            group=mesh.dp_group, name="overflow")
    return out


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
    other entries sums. Where a pyramid level overflowed its capacity, or
    (`bricked`, which trains on micro-batches of one scene) the scene held
    more occupied level-0 bricks than `model.brick_capacity`, the update is
    skipped: parameters, optimizer moments and the schedule stay, the step
    count and the generator advance. (The JAX package computes the brick
    overflow and never reads it: it trains on the voxels it dropped.)

    Under an active mesh (`parallel/mesh.py`) `batch` is this dp rank's
    slice of the global batch: after the last micro-batch the gradients are
    summed over the ranks (`sync_gradients`), the losses are the global
    batch's and the overflow flag their MAX (`global_losses`), so every
    rank applies the same update; with the same seed a dp step equals the
    one-process step on the global batch."""
    accum = max(1, int(cfg.trainer.grad_accum_steps))
    return_preds = bool(cfg.trainer.train_split_metrics)
    bricked = cfg.model.backbone_impl == "bricked"
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
        preds = None
        if return_preds:
            masks = out.pred_masks.detach()
            if out.chunks is not None:  # this sp rank's rows: made whole
                masks = out.chunks.gather(masks, sb.levels[0].capacity,
                                          name="train_preds")
            preds = (out.pred_class.detach(), masks)
        return losses, preds

    def train_step(state: TrainState, batch: DeviceBatch
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[tuple]]:
        batch = batch.to(dev)
        check_unit_features(cfg, batch)
        if bricked and batch.coords.shape[0] != accum:
            # from mask3d_tpu/models/backbone.py:324 _BrickCtx (B=1)
            raise ValueError(
                f"backbone_impl=bricked trains one scene a micro-batch: a "
                f"batch of {batch.coords.shape[0]} scenes needs "
                f"trainer.grad_accum_steps={batch.coords.shape[0]} (set "
                f"data.batch_size equal to trainer.grad_accum_steps; "
                f"grad_accum_steps is {accum})")
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
        sync_gradients(state.model, cfg.model.sp_axis)
        losses = global_losses(losses)
        # One host read of the overflow flag a step, to skip the update
        # (the JAX step selects the old state on the device instead).
        if not bool(losses["batch_overflow"] > 0):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        return losses, preds

    return train_step


# from mask3d_tpu/train/loop.py:394 measure_model_phases
def measure_model_phases(cfg, model: Mask3D, batch: DeviceBatch,
                         reps: int = 3, device="cuda") -> Dict[str, float]:
    """Seconds of each phase of one eval forward on `batch`, recorded into
    `utils.meter` under the JAX package's names in its order:
    "sparse_context_build", then "model_forward_backbone_part1", "_part2",
    "_pos_enc", "_queries", one "model_forward_decoder_<d>" per decoder
    and "model_forward_final_mask_module". Returns the `model_forward_*`
    seconds.

    Eager PyTorch runs the phases in sequence, so one fenced forward
    gives them all: a CUDA event is recorded at each boundary that
    `Mask3D.forward(phase_mark=)` reports (host clocks on the CPU), and
    each phase is the time between its event and the one before, the mean
    of `reps` eval forwards (`aux_masks`, as the eval step) after a
    warm-up. (The JAX package times jitted prefixes of the forward
    instead, since XLA runs it as one executable.)"""
    from mask3d_tpu_torch.utils import meter

    dev = resolve_device(device)
    batch = batch.to(dev)
    caps = level_capacities(cfg, batch.capacity)
    on_card = dev.type == "cuda"
    was_training = model.training
    model.eval()
    runs = []
    for _ in range(reps + 1):
        marks = []

        def mark(name):
            if on_card:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev))
            else:
                marks.append((name, time.perf_counter()))

        with torch.inference_mode():
            if on_card:
                torch.cuda.synchronize(dev)
            mark("start")
            sb = build_sparse_batch(batch.coords, batch.counts, batch.dims,
                                    caps, batch.grid_dims, **_sb_kwargs(cfg))
            mark("sparse_context_build")
            model(sb, batch.feats, batch.coords.float(), batch.grid_dims,
                  aux_masks=True, phase_mark=mark)
            mark("final_mask_module")
        if on_card:
            torch.cuda.synchronize(dev)
        runs.append({
            name: (t0.elapsed_time(t1) / 1e3 if on_card else t1 - t0)
            for (_, t0), (name, t1) in zip(marks, marks[1:])})
    model.train(was_training)
    runs = runs[1:]  # the first is the warm-up
    segs = {}
    for name in runs[0]:
        sec = sum(r[name] for r in runs) / len(runs)
        key = (name if name == "sparse_context_build"
               else f"model_forward_{name}")
        meter.record(key, sec)
        if key != name:
            segs[key] = sec
    return segs
