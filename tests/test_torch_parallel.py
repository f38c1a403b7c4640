"""The port's `parallel/` without a process group (the JAX package's
tests/test_distributed.py in torch form: the per-rank input slicing, the
no-group no-ops, the metric logger's write guard), the slab plan and the
batch padding that the ranks share, the model options, and one spawned
2-rank `InstanceSegmentationTrainer.fit()` on gloo held to a one-process
validation on the same weights."""

import csv
import os
import sys

import numpy as np
import pytest
import torch

from mask3d_tpu_torch import build_model, collate, infer
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.data.collate import VoxelizeCollate
from mask3d_tpu_torch.parallel import comm, dist, make_mesh, mesh, \
    replicate, shard_batch, sp_min_per_shard, use_mesh
from mask3d_tpu_torch.train.logging_utils import MetricLogger
from tests import torch_dist_worker as w
from tests.test_trainer import write_scene
from tests.test_torch_trainer import TRAINER_OVERRIDES
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401


def _partition():
    g = np.array([7, 3, 9, 1, 5, 0, 4, 2])
    for pc in (1, 2, 4, 8):
        slices = [dist.local_batch_indices(g, pi, pc) for pi in range(pc)]
        assert all(len(s) == len(g) // pc for s in slices)
        np.testing.assert_array_equal(np.concatenate(slices), g)


def _deterministic():
    g = np.arange(16)
    a = dist.local_batch_indices(g, 2, 4)
    np.testing.assert_array_equal(a, dist.local_batch_indices(g, 2, 4))
    np.testing.assert_array_equal(a, g[8:12])


def _ragged():
    with pytest.raises(AssertionError):
        dist.local_batch_indices(np.arange(10), 0, 4)


def _single_process():
    g = np.arange(8)
    np.testing.assert_array_equal(dist.local_batch_indices(g), g)


@pytest.mark.parametrize("case", [_partition, _deterministic, _ragged,
                                  _single_process],
                         ids=["partition", "deterministic", "ragged",
                              "single_process"])
def test_local_batch_indices(case):
    """tests/test_distributed.py's four cases of the same arithmetic."""
    case()


def test_no_group_noops():
    """Without a process group: one rank, rank 0 writes, `maybe_initialize`
    skips a config without `trainer.distributed`, the collectives and the
    barrier return their input, the mesh is one rank and shards nothing."""
    assert not dist.initialized()
    assert dist.process_count() == 1 and dist.process_index() == 0
    assert dist.is_main_process()
    cfg = Config()
    assert cfg.trainer.distributed is False
    assert dist.maybe_initialize(cfg, "cpu") is False
    assert not dist.initialized()
    dist.barrier()
    t = torch.arange(6.0)
    assert comm.all_reduce(t) is t and comm.all_gather(t) == [t]
    assert comm.broadcast(t) is t
    m = make_mesh()
    assert (m.n_dp, m.n_sp, m.dp_group, m.sp_group) == (1, 1, None, None)
    assert shard_batch(t, m) is t
    assert replicate([t], m) == [t]
    with use_mesh(m):
        assert mesh.dp_coords() == (1, 0, None)
        assert mesh.slab_plan([(112, 80, 40)], "sp") is None
        assert not sp_min_per_shard(112, "sp")


def test_metric_logger_write_guard(tmp_path):
    """A rank other than 0 aggregates the epoch means and writes nothing."""
    d = str(tmp_path / "run")
    silent = MetricLogger(d, use_tensorboard=False, write_files=False)
    silent.log_step({"loss": 2.0}, step=0)
    assert silent.log_epoch(0, 1)["loss"] == 2.0
    assert not os.path.exists(d)
    main = MetricLogger(d, use_tensorboard=False)
    main.log_step({"loss": 1.0}, 0)
    main.log_epoch(0, 1)
    with open(os.path.join(d, "metrics.csv"), newline="") as f:
        assert [float(r["loss"]) for r in csv.DictReader(f)] == [1.0]


class _FakeSp:
    """A (1, n) mesh of this process as sp rank `rank` (no group: the plan
    reads only the mesh's shape)."""

    def __init__(self, n, rank):
        self.m = mesh.Mesh(("dp", "sp"), 1, n, 0, rank, None, object())


@pytest.mark.parametrize("n_sp", [2, 4])
def test_slab_plan_aligns_levels(n_sp):
    """The flagship grid (112 x 80 x 40): levels whose x extent gives every
    sp rank >= 4 cells shard (0-3 at sp=2, 0-2 at sp=4), each finer level's
    bounds are twice the coarser's, the last rank takes the remainder, and
    the coarser levels stay whole."""
    dims = [(112, 80, 40)]
    for _ in range(4):
        dims.append(tuple(((d - 1) >> 1) + 1 for d in dims[-1]))
    plans = []
    for r in range(n_sp):
        with use_mesh(_FakeSp(n_sp, r).m):
            plans.append(mesh.slab_plan(dims, "sp"))
            assert [sp_min_per_shard(d[0], "sp") for d in dims] == \
                [s is not None for s in plans[-1]]
    k = {2: 3, 4: 2}[n_sp]
    for li, d in enumerate(dims):
        slabs = [p[li] for p in plans]
        if li > k:
            assert slabs == [None] * n_sp
            continue
        bounds = slabs[0].bounds
        assert bounds[0] == 0 and bounds[-1] == d[0]
        assert [(s.x0, s.x1) for s in slabs] == list(zip(bounds[:-1],
                                                         bounds[1:]))
        assert min(b1 - b0 for b0, b1 in zip(bounds[:-1], bounds[1:])) >= 4
        if li < k:
            coarse = plans[0][li + 1].bounds
            assert bounds[:-1] == tuple(2 * b for b in coarse[:-1])


def test_pad_host_batch_is_the_collated_batch():
    """An item collated alone and padded to a pair's shapes is that item's
    row of the pair's batch: every array equal."""
    items = w.dp_items()
    pair = VoxelizeCollate(point_bucket_multiple=512)(items)
    one = VoxelizeCollate(point_bucket_multiple=512)(items[:1])
    d = pair.device
    got = dist.pad_host_batch(one, d.coords.shape[1],
                              d.target.labels.shape[1], d.grid_dims[0],
                              d.feats_all_ones)
    assert got.device.grid_dims == d.grid_dims
    for name in ("coords", "counts", "dims", "feats"):
        np.testing.assert_array_equal(getattr(got.device, name),
                                      getattr(d, name)[:1], name)
    for name in ("labels", "masks", "valid", "point_instance_ids"):
        np.testing.assert_array_equal(getattr(got.device.target, name),
                                      getattr(d.target, name)[:1], name)
    np.testing.assert_array_equal(got.raw_coords, pair.raw_coords[:1])


def test_sp_axis_without_mesh_is_a_noop():
    """`model.sp_axis` with no active mesh (or one without sp ranks) runs
    the unsharded forward: bitwise the model without it."""
    cfg = apply_overrides(Config(), w.SP_OVERRIDES)
    cfg_sp = apply_overrides(Config(), w.SP_OVERRIDES + w.SP)
    host = collate(w.sp_items(2), device="cpu",
                   point_bucket_multiple=w.SP_BUCKET)
    ref, _ = infer(build_model(cfg, device="cpu"), host.device, cfg,
                   device="cpu")
    model = build_model(cfg_sp, device="cpu")
    for m in (None, make_mesh()):
        with use_mesh(m):
            got, _ = infer(model, host.device, cfg_sp, device="cpu")
        assert torch.equal(got.pred_masks, ref.pred_masks)
        assert torch.equal(got.pred_class, ref.pred_class)


@pytest.mark.parametrize("override", [
    "model.backbone_impl=gather", "model.backbone_impl=bricked",
    "model.int8_stride1=true", "model.pallas_chain=true"])
def test_sp_axis_refuses_other_impls_and_int8(override):
    """What `model.sp_axis` refuses: the int8 knobs off the dense path (on
    `dense` they run under sp). A train step on `gather` and `bricked`
    runs with it (under a mesh each sp rank takes its chunk of the
    backbone's rows, tests/test_torch_sp_train_impls.py); without a mesh
    sp is a no-op, and the step's losses equal those without `sp_axis`
    bit for bit."""
    if "backbone_impl" in override:
        from mask3d_tpu_torch.train.criterion import make_criterion
        from mask3d_tpu_torch.train.loop import init_state, make_train_step

        host = VoxelizeCollate(point_bucket_multiple=w.SP_BUCKET)(
            w.sp_items(1))
        losses = []
        for sp in (w.SP, []):
            cfg = apply_overrides(Config(), w.SP_OVERRIDES + sp + [
                override, "model.brick_dims=[8,8,8]",
                "model.brick_capacity=64"])
            state = init_state(cfg, device="cpu")
            step = make_train_step(cfg, make_criterion(cfg), device="cpu")
            losses.append(step(state, host.device)[0])
        assert losses[0].keys() == losses[1].keys()
        for k, v in losses[0].items():
            assert torch.equal(v, losses[1][k]), k
        return
    cfg = apply_overrides(Config(), w.SP_OVERRIDES + w.SP + [
        override, "model.backbone_impl=gather"])
    with pytest.raises(NotImplementedError, match="int8 stack"):
        build_model(cfg, device="cpu")


def test_two_rank_fit_writes_once_and_validates_as_one_process(
        tmp_path, monkeypatch):
    """`fit()` on 2 gloo ranks (1 epoch at batch 2, one scene a rank, then
    a validation): rank 0 alone writes the run's files, both ranks end on
    the same weights, and their validation metrics equal a one-process
    trainer's on those weights and scenes (the evaluator's exactly, the
    losses, summed over the ranks, within 1e-5)."""
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    # CSV metrics only: importing TensorBoard loads TensorFlow
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)

    root = tmp_path / "stru3d"
    rng = np.random.default_rng(0)
    for scene in ("scene_00001", "scene_00002", "scene_03000",
                  "scene_03001", "scene_03250", "scene_03251"):
        write_scene(str(root), scene, rng)
    over = TRAINER_OVERRIDES + [
        f"data.data_root={root}", "general.experiment_id=run",
        "trainer.max_epochs=1", "trainer.num_data_parallel=2"]
    ranks = w.Ranks("fit", 2, tmp_path / "ranks",
                    over + [f"general.save_dir={tmp_path / 'dp'}"])
    one_cfg = apply_overrides(Config(), over[:-1] + [
        f"general.save_dir={tmp_path / 'one'}"])
    one = InstanceSegmentationTrainer(one_cfg, device="cpu")
    (val0, sd0, run_dir, wrote0, _), (val1, sd1, _, wrote1, _) = \
        ranks.results()
    assert wrote1 == [] and wrote0, (wrote0, wrote1)
    assert {os.path.basename(p) for p in wrote0} >= {
        "config.yaml", "metrics.csv", "last-epoch.ckpt.tmp"}
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    one.model.load_state_dict(sd0)
    ref = one.eval_epoch("validation")
    assert val0 == val1
    assert set(val0) == set(ref)
    for k, v in ref.items():
        if "loss" in k:
            np.testing.assert_allclose(val0[k], v, rtol=1e-5, err_msg=k)
        else:
            assert val0[k] == v or (np.isnan(v) and np.isnan(val0[k])), k
