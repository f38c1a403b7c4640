"""RoomFormer training and evaluation engine (the JAX package's
`baseline/engine.py`).

Rebuild of `RoomFormer/main.py:20-116`, `eval.py:19-100` and
`engine.py:35-459`: epoch loops over density-map batches, polygon
extraction from the corner logits, floorplan metrics, and the Mask3D-metric
bridge for the apples-to-apples comparison (`engine.py:381-385`).

    python -m mask3d_tpu_torch.baseline.engine train --data_root ... [opts]
    python -m mask3d_tpu_torch.baseline.engine eval --data_root ... \\
        --checkpoint ... [--mask3d_bridge] [--export_las]

Runs on `--device cuda` (the default; deterministic algorithms, TF32 off)
or `--device cpu`; a CUDA request without CUDA raises. The optimizer is
optax's `adamw(2e-4, weight_decay=1e-4)` as `torch.optim.AdamW`, with no
schedule and no clipping. `--checkpoint` takes the port's own files and the
JAX engine's (`(params, opt_state)`: its weights, and for `train` its AdamW
moments and count).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from mask3d_tpu_torch.baseline.criterion2d import RoomFormerCriterion
from mask3d_tpu_torch.baseline.density_dataset import (
    FloorplanDataset,
    collate_floorplan,
)
from mask3d_tpu_torch.baseline.floorplan_eval import FloorplanEvaluator
from mask3d_tpu_torch.baseline.poly_ops import extract_room_polygons
from mask3d_tpu_torch.baseline.roomformer import (
    RoomFormer,
    flax_to_state_dict,
    load_flax,
)
from mask3d_tpu_torch.device import resolve_device
from mask3d_tpu_torch.train import checkpoint as ckpt
from mask3d_tpu_torch.train.loop import TrainState, configure_torch

logger = logging.getLogger(__name__)


# from mask3d_tpu/baseline/engine.py:39 FloorplanTrainer
class FloorplanTrainer:
    """`datasets` ({"train", "validation", "test"} of item dicts like
    `FloorplanDataset`'s) replaces the datasets read from `data_root`."""

    def __init__(
        self,
        data_root: str,
        save_dir: str = "saved/roomformer",
        lr: float = 2e-4,
        batch_size: int = 8,
        num_polys: int = 20,
        num_queries: int = 800,
        d_model: int = 256,
        enc_layers: int = 6,
        dec_layers: int = 6,
        max_epochs: int = 300,
        seed: int = 1,
        use_raster_loss: bool = True,
        datasets: Optional[dict] = None,
        valid_scenes_file_path: Optional[str] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.batch_size = batch_size
        self.num_polys = num_polys
        self.max_epochs = max_epochs
        qp = num_queries // num_polys
        # valid_scenes_file_path filters the scenes like the reference's
        # `--valid_scenes_file_path` (RoomFormer/eval.py:92-97)
        self.datasets = datasets or {
            mode: FloorplanDataset(
                data_root, mode, num_queries_per_poly=qp,
                max_polys=num_polys,
                valid_scenes_file_path=valid_scenes_file_path,
            )
            for mode in ("train", "validation", "test")
        }
        self.model = RoomFormer(
            d_model=d_model, enc_layers=enc_layers, dec_layers=dec_layers,
            num_polys=num_polys, num_queries=num_queries,
            generator=torch.Generator().manual_seed(seed),
        ).to(self.device)
        self.criterion = RoomFormerCriterion(use_raster=use_raster_loss)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=1e-4)
        self.state = TrainState(self.model, self.optimizer, None, None)
        self._rng = np.random.default_rng(seed)
        self.ckpt_mgr = ckpt.CheckpointManager(save_dir,
                                               best_metrics=("room_f1",))
        self.epoch = 0
        # seconds a batch of the last `evaluate`: data (dataset reads and
        # collation), forward (fenced by the copy to the host), post
        # (polygons, metrics, the bridge and the export)
        self.timings = {"data": [], "forward": [], "post": []}

    # from mask3d_tpu/baseline/engine.py:111 _batches
    def _batches(self, split, shuffle):
        ds = self.datasets[split]
        order = np.arange(len(ds))
        if shuffle:
            self._rng.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            items = [ds[int(i)] for i in order[s:s + self.batch_size]]
            yield collate_floorplan(items, self.num_polys)

    def _to_device(self, batch):
        density = torch.from_numpy(batch["density"]).to(self.device)
        targets = {k: torch.from_numpy(v).to(self.device)
                   for k, v in batch["targets"].items()}
        return density, targets

    def train_step(self, batch) -> dict:
        """One AdamW step on a collated batch; the losses, detached."""
        density, targets = self._to_device(batch)
        losses = self.criterion(self.model(density), targets)
        self.optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        for p in self.model.parameters():
            # optax updates every leaf: the heads behind the detached
            # reference points get a zero gradient, moment decay and weight
            # decay, where torch's AdamW would skip a parameter without one
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.state.step += 1
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def infer(self, density: np.ndarray):
        """(corner probabilities [B, P, Qp], coords [B, P, Qp, 2]) as numpy
        of a density batch [B, H, W, 1]."""
        out = self.model(torch.from_numpy(density).to(self.device))
        return (torch.sigmoid(out.pred_logits).cpu().numpy(),
                out.pred_coords.cpu().numpy())

    # from mask3d_tpu/baseline/engine.py:120 fit
    def fit(self):
        for self.epoch in range(self.epoch, self.max_epochs):
            t0 = time.time()
            losses = {}
            for batch in self._batches("train", shuffle=True):
                losses = self.train_step(batch)
            metrics = self.evaluate("validation")
            self.ckpt_mgr.save_last(self.state, self.epoch, metrics)
            self.ckpt_mgr.maybe_save_best(self.state, self.epoch, metrics)
            loss = float(losses["loss"]) if losses else float("nan")
            logger.info(f"epoch {self.epoch}: loss={loss:.3f} "
                        f"room_f1={metrics['room_f1']:.3f} "
                        f"({time.time() - t0:.0f}s)")

    # from mask3d_tpu/baseline/engine.py:144 evaluate
    def evaluate(self, split: str = "test", mask3d_bridge: bool = False,
                 export_las_dir: Optional[str] = None) -> dict:
        """Floorplan metrics; with `mask3d_bridge` also the Mask3D
        evaluator's through the polygon -> mask bridge (reference
        engine.py:381-385), and with `export_las_dir` one gt+prediction
        `.las` per scene (RoomFormer/engine.py:391-404)."""
        from mask3d_tpu_torch.baseline.roomformer_bridge import (
            evaluate_roomformer_scene,
        )
        from mask3d_tpu_torch.evalm import Mask3DEvaluator

        if export_las_dir and not mask3d_bridge:
            raise ValueError("export_las_dir requires mask3d_bridge=True")
        ev = FloorplanEvaluator()
        bridge_metrics = []
        self.timings = {"data": [], "forward": [], "post": []}
        batches = self._batches(split, shuffle=False)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            probs, coords = self.infer(batch["density"])
            t2 = time.perf_counter()
            for i, scene in enumerate(batch["scenes"]):
                polys = extract_room_polygons(probs[i], coords[i])
                ev.evaluate_scene(polys, batch["gt_polys"][i])
                if mask3d_bridge:
                    ds = self.datasets[split].ds3d
                    item = ds[ds.data.index(scene)]
                    bridge_metrics.append(evaluate_roomformer_scene(
                        item, polys, Mask3DEvaluator(), "test"))
                    if export_las_dir:
                        self._export_scene_las(item, polys, export_las_dir)
            t3 = time.perf_counter()
            for k, v in zip(("data", "forward", "post"),
                            (t1 - t0, t2 - t1, t3 - t2)):
                self.timings[k].append(v)
        return self._finalize_metrics(ev.summarize(), bridge_metrics)

    # from mask3d_tpu/baseline/engine.py:186 _export_scene_las
    def _export_scene_las(self, item: dict, polys, las_dir: str):
        from mask3d_tpu_torch.baseline.roomformer_bridge import (
            polygons_to_mask3d_prediction,
        )
        from mask3d_tpu_torch.data.collate import build_item_target
        from mask3d_tpu_torch.train.export import \
            export_las_prediction_and_gt

        os.makedirs(las_dir, exist_ok=True)
        labels = np.asarray(item["labels"])
        t_labels, t_masks, _ = build_item_target(
            labels, filter_out_classes=(0, 17, 18, 19, 21),
            filter_out_instance_ids=(-1, 0),
        )
        pred = polygons_to_mask3d_prediction(
            np.asarray(item["coordinates"]), polys, item["scene"])
        masks_gt = (np.stack(t_masks) if t_masks
                    else np.zeros((0, len(labels)), bool))
        export_las_prediction_and_gt(
            np.asarray(item["coordinates"]),
            np.asarray(item["features"]),
            np.asarray(t_labels, np.int32),
            masks_gt,
            pred["pred_masks"],
            pred["pred_classes"],
            pred["pred_scores"],
            os.path.join(las_dir, f"test_{item['scene']}.las"),
        )

    # from mask3d_tpu/baseline/engine.py:220 _finalize_metrics
    @staticmethod
    def _finalize_metrics(out: dict, bridge_metrics: list) -> dict:
        if bridge_metrics:
            for k in bridge_metrics[0]:
                if k.endswith("classes"):
                    continue
                vals = [m[k] for m in bridge_metrics if np.isfinite(m[k])]
                out[f"bridge_{k}"] = float(np.mean(vals)) if vals else np.nan
        return out

    def load(self, path: str, resume: bool = True):
        """Restore a checkpoint of the port or of the JAX engine. With
        `resume` also the optimizer (a JAX file: optax's AdamW moments and
        count) and the epoch after the saved one; without, the weights
        only."""
        if ckpt._is_port_file(path):
            ckpt.load_checkpoint(path, self.model,
                                 self.state if resume else None)
        else:
            raw = ckpt._read(path)
            if not (isinstance(raw, dict) and isinstance(raw.get("0"), dict)
                    and "params" in raw["0"]):
                raise ValueError(f"{path}: neither a port checkpoint nor a "
                                 f"JAX engine one ((params, opt_state))")
            load_flax(self.model, raw["0"])
            if resume:
                self._resume_adamw(raw.get("1"), path)
        if resume:
            self.epoch = int(ckpt.read_meta(path).get("epoch", -1)) + 1

    def _resume_adamw(self, opt_state, path: str):
        """optax.adamw's state ({"0": adam, "1": decay, "2": lr scale}, no
        schedule count) -> the AdamW state of every parameter: `mu`/`nu`
        mapped like the params, `count` the step."""
        if opt_state is None:
            raise ValueError(f"{path}: no optimizer state to resume")
        adam, sched_count = ckpt._optax_state(opt_state, path)
        if sched_count is not None:
            raise ValueError(f"{path}: an optimizer with a schedule; the "
                             f"engine's adamw has none")
        count = int(adam["count"])
        mu = flax_to_state_dict(adam["mu"]["params"])
        nu = flax_to_state_dict(adam["nu"]["params"])
        for name, p in self.model.named_parameters():
            self.optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[name].to(p.device, p.dtype),
                "exp_avg_sq": nu[name].to(p.device, p.dtype)}
        self.state.step = count


# from mask3d_tpu/baseline/engine.py:230 main
def main(argv=None):
    """The entry; returns (trainer, metrics), metrics None for `train`."""
    import argparse

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="RoomFormer engine (PyTorch)")
    ap.add_argument("command", choices=["train", "eval"])
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--save_dir", default="saved/roomformer")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_epochs", type=int, default=300)
    ap.add_argument("--mask3d_bridge", action="store_true")
    # reference RoomFormer/eval.py:92-97
    ap.add_argument("--valid_scenes_file_path", default=None,
                    help="structured3d valid-scenes filter file")
    ap.add_argument("--export_las", action="store_true",
                    help="write one gt+prediction .las per eval scene "
                         "(implies --mask3d_bridge)")
    ap.add_argument("--las_dir", default="las_export")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        configure_torch(True)
    tr = FloorplanTrainer(
        args.data_root, save_dir=args.save_dir,
        batch_size=args.batch_size, max_epochs=args.max_epochs,
        valid_scenes_file_path=args.valid_scenes_file_path, device=dev,
    )
    if args.checkpoint:
        tr.load(args.checkpoint, resume=args.command == "train")
    if args.command == "train":
        tr.fit()
        return tr, None
    metrics = tr.evaluate(
        "test",
        mask3d_bridge=args.mask3d_bridge or args.export_las,
        export_las_dir=args.las_dir if args.export_las else None,
    )
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    return tr, metrics


if __name__ == "__main__":
    main()
