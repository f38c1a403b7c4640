"""The test entry on the card (skipped without one): the eval step on the
card against the CPU, and `cli test --device cuda` against `--device cpu`
on a small data root. Imports nothing of the JAX package, which the card's
machine cannot import."""

import math
import os

import numpy as np
import pytest
import torch

SMALL = [  # tests/test_e2e.py::small_config (tests/torch_parity.py)
    "model.hidden_dim=32", "model.dim_feedforward=64",
    "model.num_queries=8", "model.num_heads=4", "model.num_decoders=2",
    "model.backbone=Res16UNet14A", "model.conv1_kernel_size=3",
    "model.sample_sizes=[32,64,128,256,512]",
    "data.point_bucket_multiple=512",
]


def _scenes(n, seed=3):
    from mask3d_tpu_torch.data.synthetic import make_synthetic_scene

    rng = np.random.default_rng(seed)
    return [make_synthetic_scene(rng, num_rooms_x=3, num_rooms_y=2,
                                 room_size=12, height=6, jitter=0.0,
                                 dropout=0.5) for _ in range(n)]


def _scaled_err(ref, got):
    ref, got = ref.double().cpu(), got.double().cpu()
    return float((got - ref).abs().max()) / max(1.0, float(ref.std()))


@pytest.mark.cuda
def test_eval_step_card_matches_cpu():
    """Outputs and every loss of the eval step within 1e-4 *
    max(1, std(ref)) of the CPU's plain versions; the kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch.infer import make_eval_step
    from mask3d_tpu_torch.ops import masked_attention as ma
    from mask3d_tpu_torch.sparse import row_gather as rg
    from mask3d_tpu_torch.train.criterion import make_criterion

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mt.apply_overrides(mt.Config(), SMALL)
    host = mt.collate(_scenes(2), device="cpu", point_bucket_multiple=512)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = mt.build_model(cfg, device=dev, seed=0)
        n_attn = ma.masked_cross_attention.launches
        n_gather = rg.row_gather.launches
        outs[dev] = make_eval_step(cfg, model, make_criterion(cfg), dev)(
            host.device)
    assert ma.masked_cross_attention.launches == n_attn + 8
    assert rg.row_gather.launches == n_gather + 13
    (rc, rm, rl), (gc, gm, gl) = outs["cpu"], outs["cuda"]
    assert _scaled_err(rc, gc) <= 1e-4
    assert _scaled_err(rm, gm) <= 1e-4
    assert sorted(rl) == sorted(gl)
    for k in rl:
        err = abs(float(gl[k]) - float(rl[k])) / max(1.0, abs(float(rl[k])))
        assert err <= 1e-4, (k, float(rl[k]), float(gl[k]))


@pytest.mark.cuda
def test_cli_test_on_the_card(tmp_path, monkeypatch):
    """`cli test --device cuda` gives the metric keys of `--device cpu`,
    every value finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    from mask3d_tpu_torch import cli
    from mask3d_tpu_torch.data.ply import write_ply
    from mask3d_tpu_torch.train import trainer as p_trainer

    root = tmp_path / "data"
    for scene, item in zip(["scene_00001", "scene_00002", "scene_03000",
                            "scene_03250"], _scenes(4)):
        c, lab = item["coordinates"], item["labels"]
        os.makedirs(root / scene)
        write_ply(str(root / scene / "point_cloud_rasterized_150.ply"),
                  {"x": c[:, 0].astype(np.int32),
                   "y": c[:, 1].astype(np.int32),
                   "z": c[:, 2].astype(np.int32),
                   "type": lab[:, 0], "room_id": lab[:, 1]})
    seen = {}
    real_test = p_trainer.InstanceSegmentationTrainer.test

    def test(self):
        seen[str(self.device)] = real_test(self)
        return seen[str(self.device)]

    monkeypatch.setattr(p_trainer.InstanceSegmentationTrainer, "test", test)
    for dev in ("cpu", "cuda"):
        assert cli.main(["test", "--device", dev, *SMALL,
                         f"data.data_root={root}",
                         "data.test_dataset_mode=trainval",
                         f"general.save_dir={tmp_path / dev}"]) == 0
    cpu, card = seen["cpu"], seen["cuda"]
    assert sorted(cpu) == sorted(card) and len(card) == 3 * 9 + 2 + 8
    assert all(math.isfinite(v) for v in card.values()), card
