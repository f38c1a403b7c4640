"""The port's train entry on the CPU: `python -m mask3d_tpu_torch.cli train`
fits, validates, saves, resumes and tests on a tiny Structured3D root
(tests/test_trainer.py:37), and the train step's guarantees mirror the JAX
package's trainer tests (tests/test_trainer.py:75-404) and its overfit test
(tests/test_e2e.py:58)."""

import csv
import os

import numpy as np
import pytest
import torch

from mask3d_tpu_torch import cli, collate
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data.collate import VoxelizeCollate
from mask3d_tpu_torch.data.datasets import DATASETS
from mask3d_tpu_torch.data.synthetic import make_synthetic_scene
from mask3d_tpu_torch.train import checkpoint as ckpt
from mask3d_tpu_torch.train import trainer as p_trainer
from mask3d_tpu_torch.train.criterion import make_criterion
from mask3d_tpu_torch.train.logging_utils import MetricLogger
from mask3d_tpu_torch.train.loop import init_state, make_train_step
from tests.test_trainer import data_root  # noqa: F401 (fixture)
from tests.torch_parity import SMALL_OVERRIDES

# tests/test_trainer.py::small_cfg as overrides
TRAINER_OVERRIDES = [
    "model.hidden_dim=32", "model.dim_feedforward=64",
    "model.num_queries=6", "model.num_heads=4", "model.num_decoders=1",
    "model.backbone=Res16UNet14A", "model.conv1_kernel_size=3",
    "model.sample_sizes=[32,64,128,256,512]",
    "data.point_bucket_multiple=1024", "data.batch_size=2",
    "data.volume_augmentations=none", "general.use_dbscan=false",
    "general.export_las=false", "general.scores_threshold=0.0",
    "trainer.max_epochs=2", "trainer.log_every_n_steps=1",
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread a test: the suite runs in several processes at
    once, and the small CPU kernels of these steps slow down by tens of
    times when every process's thread pool fights for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(root, save_dir, extra=()):
    return apply_overrides(Config(), TRAINER_OVERRIDES + [
        f"data.data_root={root}", f"general.save_dir={save_dir}",
        "general.experiment_id=run1", *extra])


def _train_batch(root, items=(0, 1)):
    ds = DATASETS["structured3d"](mode="train", data_root=root,
                                  rasterization_factor=150,
                                  volume_augmentations="none")
    coll = VoxelizeCollate(point_bucket_multiple=1024, num_queries=6)
    return coll([ds[i] for i in items]).device


def _params(state):
    return {k: p.detach().clone() for k, p in state.model.named_parameters()}


def test_cli_train_fits_resumes_and_tests(data_root, tmp_path):  # noqa: F811
    """`cli train` writes last-epoch.ckpt, best_*.ckpt, metrics.csv and the
    config snapshot; a second `cli train` with more epochs resumes at the
    saved epoch; `cli test` evaluates the trained checkpoint."""
    save_dir = str(tmp_path / "saved")
    over = TRAINER_OVERRIDES + [f"data.data_root={data_root}",
                                f"general.save_dir={save_dir}",
                                "general.experiment_id=run1"]
    seen = []
    real_fit = p_trainer.InstanceSegmentationTrainer.fit

    def fit(self):
        seen.append(self)
        return real_fit(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_trainer.InstanceSegmentationTrainer, "fit", fit)
        assert cli.main(["train", "--device", "cpu"] + over) == 0
        run_dir = seen[0].run_dir
        assert seen[0].epoch == 2 and seen[0].state.step == 2
        for name in ("last-epoch.ckpt", "last-epoch.ckpt.meta.json",
                     "metrics.csv", "config.yaml"):
            assert os.path.exists(os.path.join(run_dir, name)), name
        assert any(f.startswith("best_val_mean_ap")
                   for f in os.listdir(run_dir))
        text = open(os.path.join(run_dir, "metrics.csv")).read()
        assert "train_loss" in text and "val_mean_ap_50" in text
        from mask3d_tpu_torch.config import from_yaml, to_dict
        assert to_dict(from_yaml(os.path.join(run_dir, "config.yaml"))) == \
            to_dict(seen[0].cfg)

        # auto-resume: the saved epoch 1 -> continues at epoch 2
        assert cli.main(["train", "--device", "cpu"] + over
                        + ["trainer.max_epochs=3"]) == 0
        assert seen[1].epoch == 3 and seen[1].state.step == 3

    last = os.path.join(run_dir, "last-epoch.ckpt")
    metrics = {}
    real_test = p_trainer.InstanceSegmentationTrainer.test

    def test(self):
        metrics.update(real_test(self))
        return metrics

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(p_trainer.InstanceSegmentationTrainer, "test", test)
        assert cli.main(["test", "--device", "cpu", f"general.checkpoint={last}",
                         f"general.save_dir={tmp_path / 'test'}"] + over[:-2]
                        ) == 0
    for key in ("test_mean_ap", "test_mean_ap_50", "test_mean_ap_25",
                "test_mean_precision_50", "test_mean_recall_50",
                "test_mean_f1_50", "test_mean_match_IoU",
                "test_successfully_detected_rooms", "test_loss"):
        assert key in metrics, key


def test_checkpoint_round_trip(data_root, tmp_path):  # noqa: F811
    """A saved state restores bitwise: model, AdamW moments, schedule, step
    and generator (`load_checkpoint` with the state); the tolerant readers
    take the port's files as they take the JAX package's, and a JAX file
    cannot resume a port state."""
    cfg = small_cfg(data_root, str(tmp_path))
    state = init_state(cfg, device="cpu")
    step = make_train_step(cfg, make_criterion(cfg), device="cpu")
    batch = _train_batch(data_root)
    step(state, batch)
    path = str(tmp_path / "a.ckpt")
    ckpt.save_checkpoint(path, state, epoch=4, metadata={"val_x": 0.5})
    assert not os.path.exists(path + ".tmp")

    other = init_state(cfg, seed=9, device="cpu")
    _, meta = ckpt.load_checkpoint(path, other.model, other)
    assert meta == {"epoch": 4, "val_x": 0.5}
    assert other.step == state.step == 1
    assert torch.equal(other.generator.get_state(), state.generator.get_state())
    for k, v in state.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    a, b = state.optimizer.state_dict(), other.optimizer.state_dict()
    for i, s in a["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(torch.as_tensor(s[name]),
                               torch.as_tensor(b["state"][i][name]))
    assert other.scheduler.state_dict() == state.scheduler.state_dict()
    # the next step is the same from both
    la, _ = step(state, batch)
    lb, _ = step(other, batch)
    assert float(la["loss"]) == float(lb["loss"])

    saved = torch.load(path, weights_only=True)["model"]
    fresh = init_state(cfg, seed=9, device="cpu").model
    ckpt.load_params_tolerant(path, fresh)
    for k, v in saved.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    fresh = init_state(cfg, seed=9, device="cpu").model
    init = {k: v.clone() for k, v in fresh.state_dict().items()}
    ckpt.load_backbone_tolerant(path, fresh)
    for k, v in fresh.state_dict().items():
        want = saved[k] if k.startswith("backbone.") else init[k]
        assert torch.equal(v, want), k

    # a JAX package TrainState (two optax updates) resumes with its
    # optimizer state; a file of neither format raises
    from mask3d_tpu.config import Config as JConfig
    from mask3d_tpu.config import apply_overrides as j_apply
    from tests.test_torch_train_large import write_jax_checkpoint

    jax_file = tmp_path / "jax.ckpt"
    write_jax_checkpoint(jax_file, j_apply(JConfig(), TRAINER_OVERRIDES))
    _, meta = ckpt.load_checkpoint(str(jax_file), other.model, other)
    assert meta == {"epoch": 1} and other.step == 2
    assert all(float(s["step"]) == 2.0
               for s in other.optimizer.state.values())
    assert other.scheduler.last_epoch == 2
    junk = tmp_path / "junk.ckpt"
    junk.write_bytes(b"\x80")  # an empty msgpack map: no params
    with pytest.raises(ValueError, match="neither"):
        ckpt.load_checkpoint(str(junk), other.model, other)


def test_grad_accumulation_matches_full_batch(data_root, tmp_path):  # noqa: F811
    """grad_accum_steps=2 on a batch of two identical items: the same loss
    and update as the full batch (tests/test_trainer.py:242)."""
    item = DATASETS["structured3d"](
        mode="train", data_root=data_root, rasterization_factor=150,
        volume_augmentations="none")[0]
    batch = VoxelizeCollate(point_bucket_multiple=1024, num_queries=6)(
        [item, item]).device
    losses, params = {}, {}
    for accum in (1, 2):
        cfg = small_cfg(data_root, str(tmp_path), [
            "model.sample_sizes=[1024,1024,1024,1024,1024]",
            f"trainer.grad_accum_steps={accum}"])
        state = init_state(cfg, device="cpu")
        out, preds = make_train_step(cfg, make_criterion(cfg), "cpu")(
            state, batch)
        assert tuple(preds[1].shape[:2]) == (2, batch.capacity)
        losses[accum], params[accum] = out, _params(state)
    assert np.isfinite(float(losses[1]["loss"]))
    for k in losses[1]:
        np.testing.assert_allclose(float(losses[2][k]), float(losses[1][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the JAX test's bounds: f32 summation order through Adam's
    # normalizer on near-zero gradient elements
    for k in params[1]:
        np.testing.assert_allclose(params[2][k].numpy(), params[1][k].numpy(),
                                   rtol=1e-3, atol=2e-4, err_msg=k)


def test_capacity_overflow_skips_update(data_root, tmp_path):  # noqa: F811
    """An overflowed level skips the update: parameters, AdamW state and the
    schedule stay; the step count and the generator advance."""
    batch = _train_batch(data_root)
    cfg = small_cfg(data_root, str(tmp_path))
    state = init_state(cfg, device="cpu")
    p0 = _params(state)
    losses, _ = make_train_step(cfg, make_criterion(cfg), "cpu")(state, batch)
    assert int(losses["batch_overflow"]) == 0
    assert any(not torch.equal(p0[k], p) for k, p in _params(state).items())

    # starved coarse levels; memories of 4 rows, so the step draws samples
    cfg2 = small_cfg(data_root, str(tmp_path), [
        "data.level_cap_ratios=[0.01,0.008,0.008,0.008]",
        "model.sample_sizes=[4,4,4,4,4]"])
    state2 = init_state(cfg2, device="cpu")
    q0, g0 = _params(state2), state2.generator.get_state()
    lr0 = state2.scheduler.get_last_lr()
    losses2, _ = make_train_step(cfg2, make_criterion(cfg2), "cpu")(
        state2, batch)
    assert int(losses2["batch_overflow"]) > 0
    for k, p in _params(state2).items():
        assert torch.equal(q0[k], p), k
    assert state2.optimizer.state_dict()["state"] == {}
    assert state2.scheduler.get_last_lr() == lr0
    assert state2.step == 1
    assert not torch.equal(state2.generator.get_state(), g0)


def test_remat_backbone_matches_no_remat(data_root, tmp_path):  # noqa: F811
    """Recomputing the backbone in the backward changes memory, not math."""
    batch = _train_batch(data_root)
    out = {}
    for remat in (False, True):
        cfg = small_cfg(data_root, str(tmp_path),
                        [f"model.remat_backbone={str(remat).lower()}"])
        state = init_state(cfg, device="cpu")
        losses, _ = make_train_step(cfg, make_criterion(cfg), "cpu")(
            state, batch)
        out[remat] = (float(losses["loss"]), _params(state))
    assert np.isfinite(out[True][0])
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for k, v in out[False][1].items():
        np.testing.assert_allclose(out[True][1][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_training_determinism(data_root, tmp_path):  # noqa: F811
    """The same seed gives bitwise the same losses and parameters over two
    steps with sampled memories."""
    batch = _train_batch(data_root)
    runs = []
    for _ in range(2):
        cfg = small_cfg(data_root, str(tmp_path))
        state = init_state(cfg, device="cpu")
        step = make_train_step(cfg, make_criterion(cfg), "cpu")
        losses = [float(step(state, batch)[0]["loss"]) for _ in range(2)]
        runs.append((losses, _params(state)))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_nonfinite_loss_guard(data_root, tmp_path):  # noqa: F811
    """A non-finite train loss raises FloatingPointError naming the
    batch's scenes."""
    trainer = p_trainer.InstanceSegmentationTrainer(
        small_cfg(data_root, str(tmp_path)), device="cpu")
    real_step = trainer.train_step

    def poisoned(state, batch):
        losses, preds = real_step(state, batch)
        return dict(losses, loss=losses["loss"] * float("nan")), preds

    trainer.train_step = poisoned
    with pytest.raises(FloatingPointError, match="non-finite train loss"):
        trainer.train_epoch()


def test_train_order_and_modes(data_root, tmp_path):  # noqa: F811
    """Each epoch's train order is the next permutation of the
    config-seeded numpy generator (the JAX package's order under the same
    seed); the model trains in train mode and validates in eval mode."""
    trainer = p_trainer.InstanceSegmentationTrainer(
        small_cfg(data_root, str(tmp_path), ["data.batch_size=1"]),
        device="cpu")
    ds = trainer.datasets["train"]
    rng = np.random.default_rng(trainer.cfg.general.seed)
    for _epoch in range(2):
        order = np.arange(len(ds))
        rng.shuffle(order)
        got = [h.scenes[0] for h in trainer._batches("train", 1, True)]
        assert got == [ds[int(i)]["scene"] for i in order]
    modes = []
    real_forward = trainer.model.forward

    def forward(*a, **k):
        modes.append(trainer.model.training)
        return real_forward(*a, **k)

    trainer.model.forward = forward
    trainer.train_epoch()
    trainer.eval_epoch("validation")
    assert modes == [True] * len(ds) + [False]


def test_dropout_and_int8_in_training():
    """Train mode runs no int8 conv (the JAX package's `int8_stride1 and
    is_eval`), and dropout > 0 raises as the JAX train step does (it
    passes no dropout rng)."""
    from mask3d_tpu_torch.models import backbone as bb_mod

    cfg = apply_overrides(Config(), SMALL_OVERRIDES + [
        "model.compute_dtype=bfloat16", "model.int8_stride1=true",
        "model.unit_features=true"])
    host = collate([make_synthetic_scene(np.random.default_rng(0),
                                         num_rooms_x=2, num_rooms_y=1,
                                         room_size=12, height=6)],
                   device="cpu", point_bucket_multiple=512)
    state = init_state(cfg, device="cpu")
    assert state.model.backbone.int8_stride1
    with pytest.MonkeyPatch.context() as mp:
        def refuse(*a, **k):
            raise AssertionError("an int8 conv in train mode")
        mp.setattr(bb_mod, "dense_conv_same_int8", refuse)
        losses, _ = make_train_step(cfg, make_criterion(cfg), "cpu")(
            state, host.device)
    assert np.isfinite(float(losses["loss"]))

    cfg = apply_overrides(Config(), SMALL_OVERRIDES + ["model.dropout=0.1"])
    state = init_state(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="dropout"):
        make_train_step(cfg, make_criterion(cfg), "cpu")(state, host.device)


def test_overfit_fixed_batch():
    """tests/test_e2e.py:58 on the port: small_config at lr 0.002 fits a
    fixed batch of two scenes (the loss falls below 0.6 of the first)."""
    cfg = apply_overrides(Config(), SMALL_OVERRIDES)
    rng = np.random.default_rng(3)
    host = collate([make_synthetic_scene(rng, num_rooms_x=2, num_rooms_y=1,
                                         room_size=12, height=6, jitter=0.0,
                                         dropout=0.5) for _ in range(2)],
                   device="cpu", point_bucket_multiple=512)
    state = init_state(cfg, device="cpu")
    step = make_train_step(cfg, make_criterion(cfg), "cpu")
    first = float(step(state, host.device)[0]["loss"])
    for _ in range(OVERFIT_STEPS):
        losses, _ = step(state, host.device)
    final = float(losses["loss"])
    assert np.isfinite(final) and final < 0.6 * first, (first, final)
    n_levels = cfg.model.num_decoders * len(cfg.model.hlevels)
    assert all(f"loss_ce_mask_module_{i}" in losses for i in range(n_levels))


OVERFIT_STEPS = 30


def test_metric_logger_preserves_history_across_resume(tmp_path):
    """tests/test_trainer.py:380 on the port's logger."""
    d = str(tmp_path)
    m = MetricLogger(d, use_tensorboard=False)
    m.log_step({"train_loss": 2.0}, 1)
    m.log_epoch(0, 3)
    m.log_epoch(1, 6, extra={"val_mean_ap_50": 0.5})
    m.close()

    m2 = MetricLogger(d, use_tensorboard=False)  # a resumed run
    m2.log_step({"train_loss": 1.0}, 9)
    m2.log_epoch(2, 9)
    m2.close()
    with open(tmp_path / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1", "2"]
    assert rows[1]["val_mean_ap_50"] == "0.5"
    assert rows[2]["train_loss"] == "1.0"
