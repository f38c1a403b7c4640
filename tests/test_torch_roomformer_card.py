"""The RoomFormer baseline on the card (skipped without one): the engine's
device default and two train steps repeated bitwise under deterministic
algorithms. Imports nothing of the JAX package."""

import numpy as np
import pytest
import torch

TINY = dict(num_polys=3, num_queries=12, d_model=32, enc_layers=1,
            dec_layers=2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    from mask3d_tpu_torch.train.loop import configure_torch

    configure_torch(True)


def _datasets(n=2, qp=4):
    from mask3d_tpu_torch.baseline.poly_ops import pad_polygons

    rng = np.random.default_rng(0)
    items = []
    for i in range(n):
        polys = [np.array([[40, 40], [120, 40], [120, 120], [40, 120]]),
                 np.array([[140, 60], [220, 60], [220, 180], [140, 180]])]
        density = rng.random((256, 256, 1)).astype(np.float32)
        items.append({"density": density, "targets": pad_polygons(polys, qp),
                      "gt_polys": polys, "scene": f"synt_{i}"})
    return {"train": items, "validation": items, "test": items}


@pytest.mark.cuda
def test_engine_runs_on_the_card_by_default(tmp_path):
    _need_card()
    from mask3d_tpu_torch.baseline.engine import FloorplanTrainer

    tr = FloorplanTrainer("unused", save_dir=str(tmp_path), batch_size=2,
                          datasets=_datasets(), **TINY)
    assert next(tr.model.parameters()).device.type == "cuda"
    metrics = tr.evaluate("test")
    assert np.isfinite(metrics["room_f1"])


@pytest.mark.cuda
def test_two_train_steps_repeat_bitwise(tmp_path):
    _need_card()
    from mask3d_tpu_torch.baseline.density_dataset import collate_floorplan
    from mask3d_tpu_torch.baseline.engine import FloorplanTrainer

    ds = _datasets()
    batch = collate_floorplan(ds["train"], TINY["num_polys"])
    runs = []
    for i in range(2):
        tr = FloorplanTrainer("unused", save_dir=str(tmp_path / str(i)),
                              batch_size=2, datasets=ds, seed=3, **TINY)
        losses = [float(tr.train_step(batch)["loss"]) for _ in range(2)]
        runs.append((losses, [p.detach().cpu() for p in
                              tr.model.parameters()]))
    assert runs[0][0] == runs[1][0] and np.isfinite(runs[0][0]).all()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
