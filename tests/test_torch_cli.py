"""The test entry end to end: `python -m mask3d_tpu_torch.cli test --device
cpu` against `python -m mask3d_tpu.cli test`, in process, on one 4-scene
Structured3D root (tests/test_trainer.py:37-43) with one checkpoint that
the JAX package saved. The JAX attention runs its Pallas kernel in
interpret mode (`model.attention_pallas_tile=16`)."""

import math

import numpy as np
import pytest
import torch

from mask3d_tpu_torch import cli
from mask3d_tpu_torch.train import trainer as p_trainer
from tests.test_e2e import MAP_TOL
from tests.torch_parity import SMALL_OVERRIDES
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

SCENES = ["scene_00001", "scene_00002", "scene_03000", "scene_03250"]
MAP_KEYS = ("test_mean_ap", "test_mean_ap_50", "test_mean_ap_25")


def _overrides(root, save_dir, checkpoint):
    return SMALL_OVERRIDES + [
        "model.attention_pallas_tile=16",
        # three scenes in one batch: padded items, the post-process pool
        "data.test_dataset_mode=trainval",
        "data.test_batch_size=3",
        "general.scores_threshold=0.0",
        f"data.data_root={root}",
        f"general.save_dir={save_dir}",
        "general.experiment_id=run",
        f"general.checkpoint={checkpoint}",
    ]


def _run_test(monkeypatch, trainer_cls, main, argv):
    """Run a cli's `test` in process; returns (metrics, trainer)."""
    seen = {}
    real_test = trainer_cls.test

    def test(self):
        seen["trainer"] = self
        seen["metrics"] = real_test(self)
        return seen["metrics"]

    monkeypatch.setattr(trainer_cls, "test", test)
    assert main(argv) == 0
    return seen["metrics"], seen["trainer"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both entries on one data root and checkpoint, with the JAX eval
    step's outputs recorded."""
    from mask3d_tpu import cli as j_cli
    from mask3d_tpu.data import VoxelizeCollate
    from mask3d_tpu.train import checkpoint as j_ckpt
    from mask3d_tpu.train import trainer as j_trainer
    from mask3d_tpu.train.loop import init_state
    from tests.test_e2e import small_config
    from tests.test_trainer import write_scene
    from tests.torch_parity import scene_items

    root = str(tmp_path_factory.mktemp("stru3d"))
    rng = np.random.default_rng(0)
    for scene in SCENES:
        write_scene(root, scene, rng)
    state, _, _, _ = init_state(small_config(), VoxelizeCollate(
        point_bucket_multiple=512)(scene_items(n=1)).device)
    ckpt_path = str(tmp_path_factory.mktemp("ckpt") / "model.ckpt")
    j_ckpt.save_checkpoint(ckpt_path, state)

    steps = []
    real_make = j_trainer.make_eval_step

    def recording_make(cfg, model, criterion):
        step = real_make(cfg, model, criterion)

        def eval_step(state, batch):
            out = step(state, batch)
            steps.append([np.asarray(out[0]), np.asarray(out[1]),
                          {k: np.asarray(v) for k, v in out[2].items()}])
            return out
        return eval_step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_trainer, "make_eval_step", recording_make)
        ref, _ = _run_test(mp, j_trainer.InstanceSegmentationTrainer,
                           j_cli.main, ["test"] + _overrides(
                               root, tmp_path_factory.mktemp("jax"),
                               ckpt_path))
    with pytest.MonkeyPatch.context() as mp:
        got, port_trainer = _run_test(
            mp, p_trainer.InstanceSegmentationTrainer, cli.main,
            ["test", "--device", "cpu"] + _overrides(
                root, tmp_path_factory.mktemp("port"), ckpt_path))
    return dict(ref=ref, got=got, steps=steps, trainer=port_trainer)


def test_entry_losses_match_jax(runs):
    """The same metric keys; every loss within 1e-4 * max(1, |ref|)."""
    ref, got = runs["ref"], runs["got"]
    assert sorted(ref) == sorted(got)
    losses = [k for k in ref if "loss" in k or k.endswith("overflow")]
    assert len(losses) == 3 * 9 + 2  # 2 decoders x 4 levels + final
    for k in losses:
        assert abs(got[k] - ref[k]) <= 1e-4 * max(1.0, abs(ref[k])), (
            k, ref[k], got[k])
    assert got["test_batch_overflow"] == 0.0


def test_entry_map_matches_jax(runs):
    ref, got = runs["ref"], runs["got"]
    for k in MAP_KEYS:
        assert math.isfinite(ref[k]), (k, ref[k])
        assert abs(got[k] - ref[k]) <= MAP_TOL, (k, ref[k], got[k])


def test_port_host_path_on_jax_outputs_gives_jax_metrics(runs):
    """The port's eval epoch (post-process thread pool, evaluator, loss
    means) fed the JAX eval step's own outputs gives JAX's metric dict
    exactly."""
    replay = iter(runs["steps"])
    trainer = runs["trainer"]

    def eval_step(batch):
        pc, pm, losses = next(replay)
        return (torch.tensor(pc), torch.tensor(pm),
                {k: torch.tensor(v) for k, v in losses.items()})

    trainer.eval_step = eval_step
    got = trainer.test()
    ref = runs["ref"]
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k])), (
            k, ref[k], got[k])


def test_cli_forms_and_refusals(tmp_path, monkeypatch):
    """`general.train_mode` picks the command (`fit` or `test`); an unknown
    device raises, and so do data parallelism without a card a rank or
    with a world size other than `trainer.num_data_parallel`, and
    `model.sp_axis` on a gather backbone."""
    ran = []

    class Recording:
        def __init__(self, cfg, device):
            self.cfg = cfg

        def fit(self):
            ran.append(("fit", self.cfg.general.train_mode))

        def test(self):
            ran.append(("test", self.cfg.general.train_mode))
            return {}

    with monkeypatch.context() as mp:
        mp.setattr(p_trainer, "InstanceSegmentationTrainer", Recording)
        cli.main(["--device", "cpu", "general.train_mode=true"])
        cli.main(["--device", "cpu", "general.train_mode=false"])
        cli.main(["train", "--device", "cpu"])
    assert ran == [("fit", True), ("test", False), ("fit", True)]
    with pytest.raises(SystemExit):
        cli.main(["test", "--device=tpu"])
    assert cli._take_device(["test", "--device", "cpu", "a=b"]) == (
        "cpu", ["test", "a=b"])
    # data parallelism: a local launch needs one CUDA card a rank, and
    # under trainer.distributed num_data_parallel is the world size
    with pytest.raises(RuntimeError, match=r"one rank a CUDA card and this "
                                           r"host has \d+ card"):
        cli.main(["test", "--device", "cpu", "trainer.num_data_parallel=2",
                  f"general.save_dir={tmp_path}"])
    with pytest.raises(ValueError, match="must equal the world size 1"):
        cli.main(["train", "--device", "cpu", "trainer.distributed=true",
                  "trainer.num_data_parallel=2", "trainer.process_id=0",
                  "trainer.num_processes=1",
                  f"trainer.coordinator_address=localhost:{cli._free_port()}",
                  f"general.save_dir={tmp_path}"])
    assert not torch.distributed.is_initialized()
    # sequence parallelism trains on every impl (the other impls than
    # dense run the backbone whole and shard the decoder's rows); without
    # a mesh it is a no-op: a train forward on gather runs
    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch.config import Config, apply_overrides
    from mask3d_tpu_torch.infer import _sb_kwargs, level_capacities
    from mask3d_tpu_torch.sparse.context import build_sparse_batch
    from tests.torch_parity import scene_items

    cfg = apply_overrides(Config(), SMALL_OVERRIDES + [
        "model.sp_axis=sp", "model.backbone_impl=gather"])
    model = mt.build_model(cfg, device="cpu").train()
    dev = mt.collate(scene_items(n=1), device="cpu",
                     point_bucket_multiple=512).device
    sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                            level_capacities(cfg, dev.capacity),
                            dev.grid_dims, **_sb_kwargs(cfg))
    out = model(sb, dev.feats, dev.coords.float(), dev.grid_dims,
                generator=torch.Generator().manual_seed(0))
    assert out.chunks is None
    assert bool(torch.isfinite(out.aux_pred_masks).all())
