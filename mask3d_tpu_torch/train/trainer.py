"""The JAX package's trainer (mask3d_tpu/train/trainer.py): run directory,
datasets, voxelizing collation on a prefetch thread, the train step
(`train/loop.py`) over a config-seeded shuffled order with train-split
metrics, validation every `check_val_every_n_epoch` (the eval step on the
device, host post-processing in a thread pool, the evaluator, the optional
exports), `last-epoch.ckpt` and `best_*.ckpt`, auto-resume, the metric
logger, and `test`.

Data parallelism (`trainer.num_data_parallel` ranks, in a process group
that `parallel/dist.py` or the cli's local launcher initialised): every
rank draws the same epoch order and collates its slice of each global
batch, padded to the shapes the ranks share; the train step sums the
gradients and losses over the ranks; validation and test gather the
post-processed items to rank 0 in global order, which runs the evaluator;
only rank 0 writes the config, checkpoints and metrics. `backbone_impl=bricked`
trains on micro-batches of one scene (`data.batch_size` equal to
`trainer.grad_accum_steps`), evaluates at `data.test_batch_size=1` and
raises on an eval batch whose bricks or levels overflowed. A run directory
whose `last-epoch.ckpt` the JAX package wrote resumes with its optimizer
state (`train/checkpoint.py`).
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from mask3d_tpu_torch.config import Config, flatten_dict, to_dict, to_yaml
from mask3d_tpu_torch.data.batch import HostBatch
from mask3d_tpu_torch.data.collate import VoxelizeCollate
from mask3d_tpu_torch.data.datasets import DATASETS
from mask3d_tpu_torch.device import resolve_device
from mask3d_tpu_torch.evalm import Mask3DEvaluator
from mask3d_tpu_torch.infer import make_eval_step
from mask3d_tpu_torch.parallel import dist
from mask3d_tpu_torch.parallel.mesh import make_mesh, replicate, \
    state_tensors, use_mesh
from mask3d_tpu_torch.postprocess import postprocess_item
from mask3d_tpu_torch.train import checkpoint as ckpt
from mask3d_tpu_torch.train.criterion import make_criterion
from mask3d_tpu_torch.train.export import (
    export_las_prediction_and_gt,
    export_prediction_generic,
)
from mask3d_tpu_torch.train.logging_utils import MetricLogger
from mask3d_tpu_torch.train.loop import global_losses, init_state, \
    make_train_step, measure_model_phases
from mask3d_tpu_torch.utils import meter

logger = logging.getLogger(__name__)


# from mask3d_tpu/train/trainer.py:55 _prefetch
def _prefetch(iterable: Iterable, depth: int = 2):
    """Background-thread prefetcher: the next batches are collated while
    the device runs the current one. An exception in the producer is
    raised in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for x in iterable:
                q.put((x, None))
        except BaseException as e:  # handed to the consumer, raised there
            q.put((None, e))
        finally:
            q.put((done, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        x, err = q.get()
        if err is not None:
            raise err
        if x is done:
            break
        yield x


# from mask3d_tpu/train/trainer.py:76 InstanceSegmentationTrainer
class InstanceSegmentationTrainer:
    def __init__(self, cfg: Config, datasets: Optional[dict] = None,
                 device="cuda"):
        world = dist.process_count()
        if world > 1 or cfg.trainer.num_data_parallel > 1:
            # from mask3d_tpu/config.py:283-292: num_data_parallel counts
            # the global ranks
            if cfg.trainer.num_data_parallel != world:
                raise ValueError(
                    f"trainer.num_data_parallel="
                    f"{cfg.trainer.num_data_parallel} but the process group "
                    f"has {world} rank(s): start one rank a card (cli train "
                    f"trainer.num_data_parallel=N, or torchrun with "
                    f"trainer.distributed=true and N processes)")
        self.cfg = cfg
        self.is_main = dist.is_main_process()
        self.device = (dist.local_device(device) if world > 1
                       else resolve_device(device))
        # a 1-D dp mesh over the ranks (None in one process)
        self.mesh = make_mesh(world) if world > 1 else None
        if cfg.trainer.debug_nans:
            # the JAX package's jax_debug_nans: raise where the backward
            # makes a NaN
            torch.autograd.set_detect_anomaly(True)
        run_dir = [os.path.join(
            cfg.general.save_dir,
            cfg.general.experiment_name,
            cfg.general.experiment_id or time.strftime("%Y-%m-%d_%H-%M-%S"),
        )]
        if world > 1:  # rank 0's clock names the run
            torch.distributed.broadcast_object_list(run_dir, src=0)
        self.run_dir = run_dir[0]
        if self.is_main:
            os.makedirs(self.run_dir, exist_ok=True)
            # the composed config, so a run reproduces from its artifacts
            to_yaml(cfg, os.path.join(self.run_dir, "config.yaml"))

        if datasets is not None:
            self.datasets = datasets
        else:
            ds_cls = DATASETS[cfg.data.dataset]
            common = dict(
                data_root=cfg.data.data_root,
                rasterization_factor=cfg.data.rasterization_factor,
                valid_scenes_file_path=cfg.data.valid_scenes_file_path,
                prediction_label_offset=cfg.data.prediction_label_offset,
                filter_out_classes=cfg.data.filter_out_classes,
                filter_out_instance_ids=cfg.data.filter_out_instance_ids,
            )
            if cfg.data.dataset != "structured3d":
                common.pop("valid_scenes_file_path")
            # All three splits, as the JAX package builds them: a data root
            # is accepted or refused exactly as there.
            self.datasets = {
                "train": ds_cls(
                    mode=cfg.data.train_dataset_mode,
                    volume_augmentations=cfg.data.volume_augmentations,
                    data_fraction=cfg.data.data_fraction,
                    **common,
                ),
                "validation": ds_cls(
                    mode=cfg.data.validation_dataset_mode, **common
                ),
                "test": ds_cls(mode=cfg.data.test_dataset_mode, **common),
            }

        self.collate = VoxelizeCollate(
            filter_out_classes=cfg.data.filter_out_classes,
            filter_out_instance_ids=cfg.data.filter_out_instance_ids,
            prediction_label_offset=cfg.data.prediction_label_offset,
            point_bucket_multiple=cfg.data.point_bucket_multiple,
            instance_bucket_multiple=cfg.data.instance_bucket_multiple,
            num_queries=cfg.model.num_queries,
            min_grid_dims=cfg.data.min_grid_dims,
            grid_dims_cap=cfg.data.grid_dims_cap,
        )

        # the model and its optimizer state; an example train batch checks
        # `model.unit_features`
        example = self.collate([self.datasets["train"][0]]).device
        self.state = init_state(cfg, example, device=self.device)
        if self.mesh is not None:
            replicate(state_tensors(self.state), self.mesh)
        self.model = self.state.model
        self.criterion = make_criterion(cfg)
        self.train_step = make_train_step(cfg, self.criterion, self.device)
        self.eval_step = make_eval_step(cfg, self.model, self.criterion,
                                        self.device)
        self.evaluator = Mask3DEvaluator(
            debug_best_worst_scenes=cfg.general.debug_best_worst_scenes,
            debug_mean_average_precision=cfg.general.debug_mean_average_precision,
        )
        self.ckpt_mgr = ckpt.CheckpointManager(self.run_dir,
                                               write=self.is_main)
        self.metrics = MetricLogger(
            self.run_dir, hyperparams=flatten_dict(to_dict(cfg)),
            write_files=self.is_main)
        self.epoch = 0
        self._rng = np.random.default_rng(cfg.general.seed)

        if cfg.general.checkpoint:
            ckpt.load_params_tolerant(cfg.general.checkpoint, self.model)
        elif cfg.general.backbone_checkpoint:
            ckpt.load_backbone_tolerant(cfg.general.backbone_checkpoint,
                                        self.model)

    # from mask3d_tpu/train/trainer.py:188 _batches
    def _batches(self, split: str, batch_size: int, shuffle: bool):
        """The split's batches: with `shuffle`, an order drawn from the
        config-seeded generator (the JAX package's order under the same
        seed), `general.reps_per_epoch` times. Under data parallelism every
        rank draws the same order and collates its contiguous slice of each
        global batch (`dist.local_batch_indices`); a batch that does not
        split evenly over the ranks raises. (The JAX package's multi-host
        path collates a ragged batch whole on every host, so each of its
        items counts once a host: ROADMAP Queue 3.)"""
        ds = self.datasets[split]
        order = np.arange(len(ds))
        if shuffle:
            self._rng.shuffle(order)
        pc = dist.process_count()
        for _rep in range(self.cfg.general.reps_per_epoch if shuffle else 1):
            for s in range(0, len(order), batch_size):
                idxs = order[s:s + batch_size]
                if pc > 1:
                    if len(idxs) % pc:
                        raise ValueError(
                            f"a {split} batch of {len(idxs)} scenes does not"
                            f" split over the world size {pc}: make "
                            f"data.batch_size ({batch_size} here for "
                            f"{split}) and the split's size multiples of "
                            f"{pc}")
                    idxs = dist.local_batch_indices(idxs)
                yield self.collate([ds[int(i)] for i in idxs])

    def _to_device(self, host: HostBatch):
        """The batch's one host-to-device copy, on the caller's thread;
        under data parallelism padded first to the shapes the ranks share
        (`dist.put_global`)."""
        if self.mesh is not None:
            return dist.put_global(host, self.device, self.mesh.dp_group)[1]
        return host.device.to(self.device)

    def _evaluate(self, preds, targets, prefix):
        """The evaluator's metrics of one batch (its `<prefix>_classes`
        dropped). Under data parallelism each rank holds its items: rank 0
        gathers them in global item order, evaluates, and every rank gets
        its metrics, which equal the one-process run's."""
        if self.mesh is None:
            m = self.evaluator.evaluate(preds, targets, prefix)
        else:
            group = self.mesh.dp_group
            parts = [None] * dist.process_count() if self.is_main else None
            torch.distributed.gather_object((preds, targets), parts, dst=0,
                                            group=group)
            m = [None]
            if self.is_main:
                m[0] = self.evaluator.evaluate(
                    [p for part in parts for p in part[0]],
                    [t for part in parts for t in part[1]], prefix)
            torch.distributed.broadcast_object_list(m, src=0, group=group)
            m = m[0]
        m.pop(f"{prefix}_classes", None)
        return m

    # from mask3d_tpu/train/trainer.py:218 _postprocess_batch
    def _postprocess_batch(self, host, pred_class, pred_masks,
                           measure: bool = False):
        """Host post-processing fan-out + target extraction for one batch:
        returns (pred_dicts, target_dicts) ready for the evaluator."""
        cfg = self.cfg
        counts = np.asarray(host.device.counts)
        n_items = len(host.scenes)

        def _post(b, measure=False):
            n = counts[b]
            return postprocess_item(
                pred_class[b],
                pred_masks[b, :n],
                host.raw_coords[b, :n],
                host.scenes[b],
                use_dbscan=cfg.general.use_dbscan,
                dbscan_eps=cfg.general.dbscan_eps,
                dbscan_min_points=cfg.general.dbscan_min_points,
                filter_out_instances=cfg.general.filter_out_instances,
                scores_threshold=cfg.general.scores_threshold,
                iou_threshold=cfg.general.iou_threshold,
                topk_per_image=cfg.general.topk_per_image,
                measure=measure,
            )

        # Per-item post-processing in a pool of up to 8 threads; a batch of
        # one item runs on this thread and records the per-stage eval
        # segments.
        if n_items > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=min(n_items, 8)) as ex:
                preds = list(ex.map(_post, range(n_items)))
        else:
            preds = [_post(0, measure=measure)]
        targets = []
        for b in range(n_items):
            n = counts[b]
            tv = np.asarray(host.device.target.valid[b])
            targets.append(
                {
                    "labels": np.asarray(host.device.target.labels[b])[tv],
                    "masks": np.asarray(
                        host.device.target.masks[b]
                    )[tv][:, :n],
                }
            )
        return preds, targets

    # from mask3d_tpu/train/trainer.py:269 _check_step
    def _check_step(self, step: int, losses, scenes, counts) -> None:
        """Per-step guards, read two steps late: a non-finite loss raises
        FloatingPointError with the batch's scenes; a level-capacity
        overflow (the step skipped its update) is logged."""
        loss_val = float(losses["loss"])
        if int(losses["batch_overflow"]) > 0:
            logger.warning(
                "level-capacity overflow at step %d — optimizer update "
                "skipped: scenes=%s point_counts=%s; widen "
                "data.level_cap_ratios or the point bucket.",
                step, list(scenes), counts.tolist(),
            )
        if not np.isfinite(loss_val):
            logger.error(
                "non-finite train loss at step %d: scenes=%s "
                "point_counts=%s",
                step, list(scenes), counts.tolist(),
            )
            raise FloatingPointError(
                f"non-finite train loss at step {step} "
                f"(scenes={list(scenes)})"
            )

    def _profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        prof_dir = os.path.join(self.run_dir, "profile")
        os.makedirs(prof_dir, exist_ok=True)
        path = os.path.join(prof_dir, f"trace_step{self.state.step}.json")
        prof.export_chrome_trace(path)
        logger.info(f"profiler trace written to {path}")

    # from mask3d_tpu/train/trainer.py:300 train_epoch
    def train_epoch(self) -> Dict[str, float]:
        """One pass over the shuffled train split; returns the epoch means
        that `MetricLogger.log_epoch` wrote. `trainer.profile_steps` traces
        the steps from `trainer.profile_start` with `torch.profiler`."""
        cfg = self.cfg
        self.model.train()
        pending: deque = deque()  # (step, losses, scenes, counts)
        check_lag = 2
        prof = None
        for host in _prefetch(
            self._batches("train", cfg.data.batch_size, shuffle=True)
        ):
            step_now = self.state.step
            if cfg.trainer.profile_steps and \
                    step_now == cfg.trainer.profile_start:
                prof = self._profiler()
            meter.notify_start_item()
            batch = self._to_device(host)
            meter.add_timing("data_preparation")
            losses, preds = self.train_step(self.state, batch)
            if prof is not None and step_now == (
                    cfg.trainer.profile_start + cfg.trainer.profile_steps):
                self._stop_profiler(prof)
                prof = None
            step = step_now + 1
            pending.append(
                (step, losses, host.scenes, np.asarray(host.device.counts)))
            while len(pending) > check_lag:
                self._check_step(*pending.popleft())
            if cfg.trainer.train_split_metrics and preds is not None:
                # evaluator metrics on the train forward's predictions
                pd, tg = self._postprocess_batch(
                    host, preds[0].cpu().numpy(), preds[1].cpu().numpy())
                m = self._evaluate(pd, tg, "train")
                self.metrics.log_step(
                    {k: float(v) for k, v in m.items()}, step)
            if step % cfg.trainer.log_every_n_steps == 0:
                values = torch.stack(
                    [v.float() for v in losses.values()]).cpu().numpy()
                meter.add_timing("model_forward_complete")
                meter.add_timing("logging_prep")
                self.metrics.log_step(
                    {f"train_{k}": float(v) for k, v in zip(losses, values)},
                    step)
                meter.add_timing("logging")
            meter.notify_end_item()
        if prof is not None:
            self._stop_profiler(prof)
        while pending:
            self._check_step(*pending.popleft())
        return self.metrics.log_epoch(self.epoch, self.state.step)

    # from mask3d_tpu/train/trainer.py:355 eval_epoch
    def eval_epoch(self, split: str, export: bool = False
                   ) -> Dict[str, float]:
        cfg = self.cfg
        self.model.eval()
        prefix = {"validation": "val"}.get(split, split)
        self.evaluator.notify_new_epoch()
        bs = (
            cfg.data.test_batch_size
            if cfg.data.test_batch_size > 0
            else cfg.data.batch_size
        )
        bricked = cfg.model.backbone_impl == "bricked"
        if bricked and bs != 1:
            raise ValueError(
                f"backbone_impl=bricked runs one scene a forward: set "
                f"data.test_batch_size=1 (the {split} batch is {bs})")
        all_metrics: List[dict] = []
        loss_acc: Dict[str, list] = {}
        for host in _prefetch(self._batches(split, bs, shuffle=False)):
            meter.notify_start_item()
            batch = self._to_device(host)
            meter.add_timing("data_preparation")
            pred_class, pred_masks, losses = self.eval_step(batch)
            losses = global_losses(losses)  # the global batch's (dp)
            pred_class = pred_class.cpu().numpy()
            pred_masks = pred_masks.cpu().numpy()
            meter.add_timing("model_forward_complete")
            # every loss in one device-to-host copy
            values = torch.stack([v.float() for v in losses.values()]
                                 ).cpu().numpy()
            for k, v in zip(losses, values):
                loss_acc.setdefault(f"{prefix}_{k}", []).append(float(v))
            meter.add_timing("loss_calculation")
            if bricked and loss_acc[f"{prefix}_batch_overflow"][-1] > 0:
                # the voxels of bricks past the capacity would be dropped
                # silently (the JAX package's bricked path does so)
                raise RuntimeError(
                    f"{split} scene {host.scenes[0]}: more occupied level-0 "
                    f"bricks than model.brick_capacity="
                    f"{cfg.model.brick_capacity}, or a pyramid level past "
                    f"its capacity (data.level_cap_ratios)")
            if loss_acc.get(f"{prefix}_batch_overflow", [0.0])[-1] > 0:
                # predictions built on clamped pyramid levels are degraded
                logger.warning(
                    "level-capacity overflow in %s batch (scenes=%s): "
                    "metrics for this batch are unreliable; widen "
                    "data.level_cap_ratios.",
                    split, list(host.scenes),
                )

            counts = np.asarray(host.device.counts)
            preds, targets = self._postprocess_batch(
                host, pred_class, pred_masks, measure=True
            )
            meter.add_timing("eval_postprocess")
            all_metrics.append(self._evaluate(preds, targets, prefix))
            meter.add_timing("eval_metrics_calc")

            if export and (cfg.general.export_las or cfg.general.export):
                base = os.path.join(
                    self.run_dir, f"epoch_{self.epoch}", f"{split}_preds"
                )
                os.makedirs(base, exist_ok=True)
                for b in range(len(host.scenes)):
                    n = counts[b]
                    if cfg.general.export_las:
                        export_las_prediction_and_gt(
                            host.raw_coords[b, :n],
                            host.raw_feats[b, :n],
                            targets[b]["labels"],
                            targets[b]["masks"],
                            preds[b]["pred_masks"],
                            preds[b]["pred_classes"],
                            preds[b]["pred_scores"],
                            os.path.join(base, f"{host.scenes[b]}.las"),
                        )
                    if cfg.general.export:
                        export_prediction_generic(
                            base,
                            host.scenes[b],
                            preds[b]["pred_masks"],
                            preds[b]["pred_scores"],
                            preds[b]["pred_classes"],
                            cfg.general.generic_export_score_threshold,
                        )
                meter.add_timing("eval_export")
            meter.notify_end_item()

        epoch_means = {
            k: float(np.mean(v)) for k, v in loss_acc.items()
        }
        metric_keys = all_metrics[0].keys() if all_metrics else []
        for k in metric_keys:
            vals = [m[k] for m in all_metrics if np.isfinite(m[k])]
            epoch_means[k] = float(np.mean(vals)) if vals else float("nan")
        return epoch_means

    # from mask3d_tpu/train/trainer.py:441 fit
    def fit(self):
        """Train to `trainer.max_epochs`, resuming from the run directory's
        `last-epoch.ckpt` where there is one. SIGTERM or Ctrl-C saves
        `last-epoch.ckpt` at the last finished epoch before it re-raises,
        so a resumed run replays at most the interrupted epoch. Every rank
        reads the resume; rank 0 alone writes."""
        with use_mesh(self.mesh):
            self._fit()

    def _fit(self):
        resume = self.ckpt_mgr.resume_path()
        if resume:
            logger.info(f"auto-resuming from {resume}")
            _, meta = ckpt.load_checkpoint(resume, self.model, self.state,
                                           seed=self.cfg.general.seed)
            self.epoch = int(meta.get("epoch", 0)) + 1

        def _sigterm(_signum, _frame):
            raise KeyboardInterrupt

        try:
            prev_handler = signal.signal(signal.SIGTERM, _sigterm)
        except ValueError:  # not the main thread
            prev_handler = None
        try:
            self._fit_loop()
        except KeyboardInterrupt:
            if self.epoch > 0:
                logger.warning(
                    "interrupted — saving last-epoch.ckpt at epoch %d",
                    self.epoch - 1,
                )
                self.ckpt_mgr.save_last(self.state, self.epoch - 1, {})
            raise
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    # from mask3d_tpu/train/trainer.py:476 _fit_loop
    def _fit_loop(self):
        cfg = self.cfg
        while self.epoch < cfg.trainer.max_epochs:
            t0 = time.time()
            train_metrics = self.train_epoch()
            val_metrics = {}
            if (self.epoch + 1) % cfg.trainer.check_val_every_n_epoch == 0:
                val_metrics = self.eval_epoch(
                    "validation",
                    export=cfg.general.export_las
                    and (self.epoch + 1) % cfg.general.export_freq == 0,
                )
                self.metrics.log_epoch(
                    self.epoch, self.state.step, extra=val_metrics
                )
            if (
                (self.epoch + 1) % cfg.trainer.save_last_every_n_epochs == 0
                or self.epoch + 1 == cfg.trainer.max_epochs
            ):
                self.ckpt_mgr.save_last(self.state, self.epoch, val_metrics)
            self.ckpt_mgr.maybe_save_best(self.state, self.epoch, val_metrics)
            dist.barrier()  # rank 0's files are whole before any rank reads
            logger.info(
                f"epoch {self.epoch}: "
                f"train_loss={train_metrics.get('train_loss', float('nan')):.4f} "
                f"val_mAP50={val_metrics.get('val_mean_ap_50', float('nan')):.4f} "
                f"({time.time() - t0:.1f}s)"
            )
            self.epoch += 1
        self.metrics.close()

    # from mask3d_tpu/train/trainer.py:509 test
    def test(self) -> Dict[str, float]:
        with use_mesh(self.mesh):
            return self._test()

    def _test(self) -> Dict[str, float]:
        meter.reset()
        if self.cfg.trainer.measure_model_phases:
            # from mask3d_tpu/train/trainer.py:511-525 measure_model_phases:
            # the model_forward_* segments of one test batch
            bs = (self.cfg.data.test_batch_size
                  if self.cfg.data.test_batch_size > 0
                  else self.cfg.data.batch_size)
            host = next(iter(self._batches("test", bs, shuffle=False)))
            measure_model_phases(self.cfg, self.model, self._to_device(host),
                                 device=self.device)
        metrics = self.eval_epoch("test", export=True)
        meter.log_final_statistics()
        if self.cfg.general.debug_best_worst_scenes:
            hi, lo = self.evaluator.get_highest_lowest_metric_scenes(
                "mean_ap", 10
            )
            logger.info("Best scenes:")
            for name, m in hi:
                logger.info(f"   ({name}): {m}")
            logger.info("Worst scenes:")
            for name, m in lo:
                logger.info(f"   ({name}): {m}")
        if self.cfg.general.debug_mean_average_precision:
            logger.info(
                "mAP components: "
                f"{self.evaluator.get_mean_average_precision_components()}"
            )
        return metrics
