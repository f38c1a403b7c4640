"""The training rehearsal as a whole, at a small width on the CPU
(`mask3d_tpu_torch/train_rehearsal.py`, the port of
tools/train_rehearsal.py): the tool's overrides, scenes and pinned grid,
then small_config on the `gather` backbone (the dense grids of the
mixture's scenes make a CPU step of the dense backbone take minutes) at
batch 1:

- the first train step of the rehearsal's trainer, on the first batch of
  its shuffled order, against the JAX package's train-step loss on the
  same batch and weights (within 1e-4 relative; the sampled memories from
  the same numpy uniforms, both matchers on scipy);
- one epoch of `main` with a validation reaches the three gates, and the
  restore gate passes;
- the restore check fails on a one-ulp change to one leaf."""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from mask3d_tpu_torch import bridge, train_rehearsal as reh
from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer
from tests.test_torch_train_step import LOSS_RTOL, OVERRIDES, Uniforms, \
    host_lsap
from tests.torch_parity import SMALL_OVERRIDES
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)
from tests.torch_train_parity import jax_train_loss

EXTRA = SMALL_OVERRIDES + OVERRIDES + [
    "model.backbone_impl=gather", "data.batch_size=1",
    "trainer.grad_accum_steps=1", "trainer.log_every_n_steps=1"]
# 13 train scenes: the shuffled order's first is scene 1, a 3,958-point
# room (the first scenes of the others hold ~25k points)
PARITY_SPLITS = (13, 1, 1)
RUN_SPLITS = (1, 1, 1)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The metric logger writes its CSV only (importing
    torch.utils.tensorboard pulls in TensorFlow, seconds of a test)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_first_step_matches_jax_train_step(tmp_path, monkeypatch):
    from mask3d_tpu.config import Config as JConfig
    from mask3d_tpu.config import apply_overrides as j_apply
    from mask3d_tpu.data import VoxelizeCollate as JCollate

    cfg = reh.build_config(1, str(tmp_path), EXTRA)
    datasets = reh.rehearsal_datasets(PARITY_SPLITS)
    reh.pin_grid(cfg, datasets)
    trainer = InstanceSegmentationTrainer(cfg, datasets=datasets,
                                          device="cpu")
    host = next(trainer._batches("train", cfg.data.batch_size,
                                 shuffle=True))
    assert list(host.scenes) == ["synthetic_1_1"]

    j_cfg = j_apply(JConfig(), reh.overrides(1, str(tmp_path)) + EXTRA)
    j_cfg.data.min_grid_dims = cfg.data.min_grid_dims
    order = np.arange(PARITY_SPLITS[0])
    np.random.default_rng(j_cfg.general.seed).shuffle(order)
    j_host = JCollate(point_bucket_multiple=j_cfg.data.point_bucket_multiple,
                      min_grid_dims=j_cfg.data.min_grid_dims)(
        [datasets["train"][int(order[0])]])
    assert j_host.device.grid_dims == host.device.grid_dims
    for f in ("coords", "feats", "counts", "dims"):
        np.testing.assert_array_equal(np.asarray(getattr(j_host.device, f)),
                                      np.asarray(getattr(host.device, f)))

    uniforms = Uniforms(7)
    host_lsap(monkeypatch)
    ref = jax_train_loss(j_cfg, j_host.device,
                         bridge.to_flax(trainer.model.state_dict()), uniforms)
    assert uniforms.drawn  # the sampled memories were drawn
    with pytest.MonkeyPatch.context() as mp, \
            torch.backends.mkldnn.flags(enabled=False):
        mp.setattr(torch, "rand", uniforms.torch)
        losses, _ = trainer.train_step(trainer.state,
                                       trainer._to_device(host))
    assert uniforms.i == len(uniforms.drawn)
    assert trainer.state.step == 1
    got = float(losses["loss"])
    assert abs(got - ref["loss"]) <= LOSS_RTOL * abs(ref["loss"]), \
        (got, ref["loss"])
    for k, v in ref.items():
        assert abs(float(losses[k]) - v) <= 1e-4 * max(1.0, abs(v)), k


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """`main` for one epoch (one step) with a validation at its end; the
    results and what it printed."""
    save = str(tmp_path_factory.mktemp("rehearsal"))
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        try:
            res = reh.main(1, fresh=True, save_dir=save,
                           extra=EXTRA + ["trainer.check_val_every_n_epoch=1"],
                           splits=RUN_SPLITS, device="cpu")
            failed = None
        except reh.RehearsalFailed as e:
            res, failed = e.results, e
    return res, failed, out.getvalue()


def test_one_epoch_reaches_the_three_gates(run):
    res, failed, printed = run
    assert list(res["gates"]) == ["loss", "val_map50", "restore"]
    assert res["steps"] == 1 and len(res["step_s"]) == 1
    assert os.path.isfile(os.path.join(res["run_dir"], "last-epoch.ckpt"))
    # the validation's row replaces the epoch's train means (the JAX
    # trainer's metric logger does the same), so one epoch has no loss
    # trajectory to gate; an untrained model scores mAP@50 0
    assert res["train_loss"] == [] and not res["gates"]["loss"]["ok"]
    assert [e for e, _ in res["val_mean_ap_50"]] == [0]
    assert not res["gates"]["val_map50"]["ok"]
    assert res["gates"]["restore"] == dict(ok=True, first_mismatch=None)
    assert failed is not None and "REHEARSAL FAIL" in printed
    for text in ("steps/s", "train_loss by epoch", "val mAP@50 trajectory",
                 "checkpoint restores bit-exact", "pinned grid"):
        assert text in printed, text


def test_restore_check_catches_a_one_ulp_change(run):
    res = run[0]
    name = reh.restore_check(res["trainer"], res["cfg"], res["datasets"],
                             "cpu", plant=True)
    first = next(iter(dict(res["trainer"].model.named_parameters())))
    assert name == first
    sd = res["trainer"].model.state_dict()
    moved = {k: v.clone() for k, v in sd.items()}
    flat = moved[first].view(-1)
    flat[-1] = torch.nextafter(flat[-1], torch.tensor(float("-inf")))
    assert reh.restore_mismatch(sd, moved) == first
    assert reh.restore_mismatch(sd, {k: v.clone() for k, v in sd.items()}) \
        is None
