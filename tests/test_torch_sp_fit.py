"""`InstanceSegmentationTrainer.fit()` under sequence parallelism: two
spawned gloo ranks (`tests/torch_dist_worker.py:fit`) build the trainer
under a 1x2 (dp, sp) mesh with `model.sp_axis`, and are held to a
one-process `fit()` of the same config in this process."""

import sys

import numpy as np
import torch

from mask3d_tpu_torch.config import Config, apply_overrides
from tests import torch_dist_worker as w
from tests.test_trainer import write_scene
from tests.test_torch_trainer import TRAINER_OVERRIDES
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401


def test_sp_fit_trains_and_validates_as_one_process(tmp_path, monkeypatch):
    """`fit()` on 2 gloo ranks built under a 1x2 (dp, sp) mesh with
    `model.sp_axis` (1 epoch: one step of batch 2 with the train-split
    metrics, then a validation) against a one-process `fit()` of the same
    config without sp: the rows were sharded (the attention's partials,
    the criterion's sums and the train-split masks crossed the ranks); the
    epoch's train losses within 1e-4 relative and its train-split
    evaluator metrics (of the step's forward on the same initial weights,
    its masks gathered whole from the ranks' chunks) equal; both ranks end
    on the same weights, and their validation on them equals a one-process
    trainer's on those weights (the evaluator's metrics exactly, the
    losses within 1e-4 relative)."""
    from mask3d_tpu_torch.train.trainer import InstanceSegmentationTrainer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    root = tmp_path / "stru3d"
    rng = np.random.default_rng(0)
    for scene in ("scene_00001", "scene_00002", "scene_03000",
                  "scene_03001", "scene_03250"):
        write_scene(str(root), scene, rng)
    over = TRAINER_OVERRIDES + [
        f"data.data_root={root}", "general.experiment_id=run",
        "trainer.max_epochs=1", "matcher.lsap_method=host"]
    ranks = w.Ranks("fit", 2, tmp_path / "ranks",
                    over + ["model.sp_axis=sp", "trainer.num_data_parallel=2",
                            f"general.save_dir={tmp_path / 'sp'}"], 2)
    one = InstanceSegmentationTrainer(apply_overrides(Config(), over + [
        f"general.save_dir={tmp_path / 'one'}"]), device="cpu")
    want = w.record_train_means(one)
    one.fit()
    (val0, sd0, _, _, got), (val1, sd1, _, wrote1, _) = ranks.results()
    assert wrote1 == []
    assert {"attention_partials", "criterion_losses", "train_preds"} <= \
        set(got["bytes"]), got["bytes"]
    got, want = got["train"][0], want[0]
    assert set(got) == set(want) and "train_loss" in want, (got, want)
    for k, v in want.items():
        if "loss" in k:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
        else:
            assert got[k] == v or (np.isnan(v) and np.isnan(got[k])), k
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    one.model.load_state_dict(sd0)
    ref = one.eval_epoch("validation")
    assert val0 == val1 and set(val0) == set(ref)
    for k, v in ref.items():
        if "loss" in k:
            np.testing.assert_allclose(val0[k], v, rtol=1e-4, err_msg=k)
        else:
            assert val0[k] == v or (np.isnan(v) and np.isnan(val0[k])), k
