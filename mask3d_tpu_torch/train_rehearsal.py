"""Scale-up training rehearsal (tools/train_rehearsal.py of the JAX
package): the flagship configuration (Mask3D + Res16UNet34C, the
reference's batch 16 by gradient accumulation) trained on realistic
multi-floor synthetic scenes (the mixture of `make_synthetic_dataset.py`:
1-18 rooms, ~45k points at most) through the whole trainer, fit ->
periodic validation -> checkpoints, then three gates in the JAX tool's
order:

- the last epoch's mean train loss is below 0.7 x the first epoch's;
- the final validation mAP@50 is at least 0.15;
- the last checkpoint restores bit for bit into a fresh trainer (every
  parameter and buffer),

and prints steps/s. The dice term needs ~1k steps to leave the
all-negative-mask regime, so shorter runs plateau at mAP@50 = 0.

    python -m mask3d_tpu_torch.train_rehearsal [num_epochs] [--fresh] \\
        [--device cuda|cpu]

(600 epochs = 1,800 steps by default.) The run resumes from its
`last-epoch.ckpt` unless `--fresh` is given. Each gate prints PASS or
FAIL; every gate is read, then a failed one raises `RehearsalFailed`
(exit 1).

Left out of the JAX tool: the JAX compile cache (tools/train_rehearsal.py:
88-92; eager PyTorch compiles nothing but the kernels, which `cuda_build`
caches in `_build/`), and the `/tmp/rehearsal.pid` file by which the JAX
bench stopped a rehearsal that held the TPU (:202-206). The run directory
is `saved/rehearsal_saved/rehearsal/run1` under the working directory
instead of `/tmp/rehearsal_saved`: the port writes nothing outside its
checkout. `main` takes a save directory, extra overrides (applied after
the tool's) and the split sizes, so that tests run it at a small width on
the CPU; their defaults are the tool's.
"""

from __future__ import annotations

import csv
import logging
import os
import shutil
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data.collate import voxelize_item
from mask3d_tpu_torch.make_synthetic_dataset import make_item, round_up_dims

SAVE_DIR = os.path.join("saved", "rehearsal_saved")
SPLITS = (48, 8, 8)  # train, validation, test scenes
SEEDS = {"train": 1, "validation": 2, "test": 3}
LOSS_RATIO = 0.7  # last epoch's train loss < LOSS_RATIO x the first's
MIN_VAL_MAP50 = 0.15


# from tools/train_rehearsal.py:98-123 apply_overrides
def overrides(num_epochs: int, save_dir: str = SAVE_DIR) -> list:
    return [
        "data.batch_size=16",
        # batch 16 as 8 micro-batches of 2: the scene mixture pins a
        # (152, 112, 32)-scale level-0 grid
        "trainer.grad_accum_steps=8",
        "model.remat_backbone=true",
        "data.point_bucket_multiple=65536",
        # the reference trains ~100k steps at lr 1e-4; this rehearsal has
        # a couple thousand, so the lr is scaled moderately (1e-3 stalled
        # the dice term in the JAX package's runs; 3e-4 moves it)
        "optimizer.lr=0.0003",
        f"trainer.max_epochs={num_epochs}",
        "trainer.check_val_every_n_epoch=50",
        # 3-step epochs: the full state's write would dominate an epoch's
        # wall time, so `last` is saved every 10
        "trainer.save_last_every_n_epochs=10",
        "trainer.log_every_n_steps=3",
        "trainer.train_split_metrics=false",  # throughput: metrics on val
        "general.use_dbscan=false",           # eval speed (not under test)
        "general.scores_threshold=0.0",
        "general.export_las=false",
        f"general.save_dir={save_dir}",
        "general.experiment_name=rehearsal",
        "general.experiment_id=run1",
    ]


# from tools/train_rehearsal.py:31 SyntheticRoomsDataset
class SyntheticRoomsDataset:
    """Fixed-seed multi-floor room scenes in the dataset item contract:
    `make_synthetic_dataset.make_item` draws in the JAX tool's order, so a
    seed gives the JAX tool's scenes, and the first k of n are the scenes
    of `SyntheticRoomsDataset(k, seed)`."""

    labels_info = {0: {"name": "is_room", "validation": True}}

    def __init__(self, n_scenes: int, seed: int):
        rng = np.random.default_rng(seed)
        self._items = []
        for i in range(n_scenes):
            item = make_item(rng)
            item["scene"] = f"synthetic_{seed}_{i}"
            item["idx"] = i
            self._items.append(item)

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]


def rehearsal_datasets(splits: Sequence[int] = SPLITS) -> dict:
    return {name: SyntheticRoomsDataset(n, seed=SEEDS[name])
            for name, n in zip(("train", "validation", "test"), splits)}


def build_config(num_epochs: int, save_dir: str = SAVE_DIR,
                 extra: Sequence[str] = ()) -> Config:
    """`Config()` with the tool's overrides, then `extra` (later wins)."""
    return apply_overrides(Config(), overrides(num_epochs, save_dir)
                           + list(extra))


# from tools/train_rehearsal.py:132-146 voxelize_item
def pin_grid(cfg: Config, datasets: dict) -> dict:
    """One level-0 grid shape for every batch of the run (the collator's
    grid floor): the elementwise max of the scenes' voxel grid dims over
    the three splits, rounded up to 8. Returns the mixture's statistics."""
    max_dims = np.zeros(3, np.int64)
    n_rooms, n_pts = [], []
    for split in datasets.values():
        for item in split:
            _, _, dims = voxelize_item(item["coordinates"])
            max_dims = np.maximum(max_dims, np.asarray(dims, np.int64))
            n_rooms.append(len(np.unique(item["labels"][:, 1])))
            n_pts.append(len(item["coordinates"]))
    cfg.data.min_grid_dims = round_up_dims(max_dims)
    return dict(rooms_min=min(n_rooms), rooms_mean=float(np.mean(n_rooms)),
                rooms_max=max(n_rooms), points_mean=float(np.mean(n_pts)),
                grid=cfg.data.min_grid_dims)


def restore_mismatch(trained: Dict[str, torch.Tensor],
                     restored: Dict[str, torch.Tensor]) -> Optional[str]:
    """The first parameter or buffer of `trained` whose bits differ from
    `restored`'s (shape, dtype or any byte), or None."""
    if trained.keys() != restored.keys():
        return f"keys {sorted(set(trained) ^ set(restored))}"
    for name, a in trained.items():
        b = restored[name]
        if a.shape != b.shape or a.dtype != b.dtype:
            return name
        a8 = a.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
        b8 = b.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
        if not torch.equal(a8, b8):
            return name
    return None


def plant_one_ulp(model: torch.nn.Module, name: Optional[str] = None) -> str:
    """Move the first element of one float parameter (the first, or
    `name`) by one ulp, in place; returns the parameter's name."""
    params = dict(model.named_parameters())
    name = name or next(iter(params))
    with torch.no_grad():
        flat = params[name].view(-1)
        flat[0] = torch.nextafter(flat[0], torch.tensor(
            float("inf"), dtype=flat.dtype, device=flat.device))
    return name


def restore_check(trainer, cfg: Config, datasets: dict, device,
                  plant: bool = False) -> Optional[str]:
    """Restore the run directory's last checkpoint into a fresh trainer
    and compare every parameter and buffer with `trainer`'s, bit for bit;
    `plant` moves one leaf of the restored model by one ulp first (a fault
    the check must catch). Returns the first mismatching leaf or None."""
    from mask3d_tpu_torch.train import checkpoint as ckpt
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    fresh = InstanceSegmentationTrainer(cfg, datasets=datasets,
                                        device=device)
    ckpt.load_checkpoint(fresh.ckpt_mgr.resume_path(), fresh.model,
                         fresh.state)
    if plant:
        plant_one_ulp(fresh.model)
    return restore_mismatch(trainer.model.state_dict(),
                            fresh.model.state_dict())


class RehearsalFailed(AssertionError):
    def __init__(self, results: dict):
        self.results = results
        failed = [k for k, v in results["gates"].items() if not v["ok"]]
        super().__init__(f"rehearsal gates failed: {failed}")


def read_metrics(run_dir: str):
    """(train loss by epoch, val mAP@50 by epoch) from metrics.csv."""
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    tr = [(int(r["epoch"]), float(r["train_loss"]))
          for r in rows if r.get("train_loss")]
    vals = [(int(r["epoch"]), float(r["val_mean_ap_50"]))
            for r in rows if r.get("val_mean_ap_50")]
    return tr, vals


def timed_steps(trainer, on_card: bool) -> list:
    """Wrap the trainer's train step to record each call's seconds (the
    device fenced on the card); returns the list it appends to."""
    seconds = []
    step = trainer.train_step

    def timed(state, batch):
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(state, batch)
        if on_card:
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return out

    trainer.train_step = timed
    return seconds


# from tools/train_rehearsal.py:85 main
def main(num_epochs: int = 60, fresh: bool = False, save_dir: str = SAVE_DIR,
         extra: Sequence[str] = (), splits: Sequence[int] = SPLITS,
         device: str = "cuda") -> dict:
    """Run (or resume) the rehearsal and read its three gates; returns the
    results, or raises `RehearsalFailed` (carrying them) where a gate
    failed."""
    from mask3d_tpu_torch.device import resolve_device
    from mask3d_tpu_torch.train.loop import configure_torch
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    dev = resolve_device(device)  # raises where CUDA is asked and absent
    on_card = dev.type == "cuda"
    cfg = build_config(num_epochs, save_dir, extra)
    if on_card:
        # before the trainer's first CUDA op, as `cli` does
        configure_torch(cfg.trainer.deterministic)
    datasets = rehearsal_datasets(splits)
    mix = pin_grid(cfg, datasets)
    steps_per_epoch = -(-len(datasets["train"]) // cfg.data.batch_size)
    print(f"scene mixture: rooms min/avg/max = {mix['rooms_min']}/"
          f"{mix['rooms_mean']:.2f}/{mix['rooms_max']} "
          f"(reference: 1/6.23/22), pts avg {mix['points_mean']:.0f}; "
          f"pinned grid {cfg.data.min_grid_dims}; {num_epochs} epochs x "
          f"{steps_per_epoch} steps (dice needs ~1k+ steps to leave the "
          f"all-negative regime)", flush=True)

    last = os.path.join(save_dir, "rehearsal", "run1", "last-epoch.ckpt")
    if fresh or not os.path.exists(last):
        shutil.rmtree(save_dir, ignore_errors=True)
    # else: the trainer resumes from last-epoch.ckpt
    trainer = InstanceSegmentationTrainer(cfg, datasets=datasets, device=dev)
    step_s = timed_steps(trainer, on_card)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    start_step = trainer.state.step
    t0 = time.time()
    trainer.fit()
    wall = time.time() - t0
    steps = trainer.state.step
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    print(f"total steps: {steps}  wall: {wall:.0f}s  "
          f"({(steps - start_step) / wall:.3f} steps/s incl. eval and "
          f"checkpoints)", flush=True)
    if step_s:
        print(f"train step: median {np.median(step_s):.3f} s over "
              f"{len(step_s)} (min {min(step_s):.3f}, max {max(step_s):.3f})"
              + (f"; peak {peak:.2f} GiB" if peak is not None else ""),
              flush=True)

    tr, vals = read_metrics(trainer.run_dir)
    gates = {}
    # from tools/train_rehearsal.py:178 loss gate
    first, last_loss = (tr[0][1], tr[-1][1]) if tr else (None, None)
    gates["loss"] = dict(ok=bool(tr) and last_loss < LOSS_RATIO * first,
                         first=first, last=last_loss)
    print(f"train_loss by epoch: {[(e, round(v, 4)) for e, v in tr]} "
          f"(gate: the last < {LOSS_RATIO} x the first): "
          f"{'PASS' if gates['loss']['ok'] else 'FAIL'}", flush=True)
    # from tools/train_rehearsal.py:183 mAP gate
    final = vals[-1][1] if vals else None
    gates["val_map50"] = dict(ok=final is not None and final >=
                              MIN_VAL_MAP50, final=final)
    print(f"val mAP@50 trajectory: {[(e, round(v, 3)) for e, v in vals]} "
          f"(gate final >= {MIN_VAL_MAP50}): "
          f"{'PASS' if gates['val_map50']['ok'] else 'FAIL'}", flush=True)
    # from tools/train_rehearsal.py:185-199 bit-exact restore
    bad = restore_check(trainer, cfg, datasets, dev)
    gates["restore"] = dict(ok=bad is None, first_mismatch=bad)
    print("checkpoint restores bit-exact" if bad is None else
          f"checkpoint restore differs at {bad}: FAIL", flush=True)
    results = dict(
        steps=steps, resumed_at_step=start_step, wall_s=wall,
        steps_per_s=(steps - start_step) / wall, step_s=step_s,
        peak_gib=peak, train_loss=tr, val_mean_ap_50=vals, gates=gates,
        mixture=mix, run_dir=trainer.run_dir, trainer=trainer, cfg=cfg,
        datasets=datasets)
    if not all(g["ok"] for g in gates.values()):
        print("REHEARSAL FAIL", flush=True)
        raise RehearsalFailed(results)
    print("REHEARSAL PASS", flush=True)
    return results


def cli_main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    fresh = "--fresh" in argv
    rest = [a for a in argv if a != "--fresh"]
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    try:
        main(int(rest[0]) if rest else 600, fresh=fresh, device=device)
    except RehearsalFailed:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(cli_main())
