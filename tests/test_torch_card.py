"""The test entry on the card (skipped without one): the eval step on the
card against the CPU, and `cli test --device cuda` against `--device cpu`
on a small data root; the int8 conv past 384 outputs and the attention's
partial form against their plain versions (the CPU side of both:
tests/test_torch_int8_bottleneck.py, tests/test_torch_sp_model.py); the
gather paths' segment sums bitwise from call to call without
deterministic mode.
Imports nothing of the JAX package, which the card's machine cannot
import."""

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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    ((112, 80, 40), 288, 256, 1), ((112, 80, 40), 256, 256, 3),
    ((112, 80, 40), 256, 1024, 1), ((112, 80, 40), 288, 1024, 1),
    ((112, 80, 40), 1024, 256, 1), ((56, 40, 20), 384, 1024, 1)])
def test_int8_kernel_matches_plain_past_384_outputs(shape):
    """The kernel against its plain version at the bottleneck's shapes on
    the flagship's level-0/1 grids (B=2, 11% occupied): outputs bitwise,
    the per-channel sums within 1e-5 of sum |term|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mask3d_tpu_torch.sparse import int8_conv as ic

    dims, cin, cout, k = shape
    gen = torch.Generator(device="cuda").manual_seed(cin + cout)
    occ = (torch.rand((2, *dims, 1), generator=gen, device="cuda")
           < 0.11).float()
    q = (torch.randint(-127, 128, (2, *dims, cin), generator=gen,
                       device="cuda", dtype=torch.int32)
         * occ.int()).to(torch.int8)
    wq = torch.randint(-127, 128, (k ** 3, cin, cout), generator=gen,
                       device="cuda", dtype=torch.int32).to(torch.int8)
    sw = torch.rand(cout, generator=gen, device="cuda") * 1e-3 + 1e-4
    got = ic.int8_conv(q, occ, wq, sw, stats=True)
    ref = ic.int8_conv_plain(q, occ, wq, sw, stats=True)
    assert torch.equal(got.out, ref.out)
    r = ref.out.float()
    scale = torch.stack([r.abs().sum(dim=(1, 2, 3)),
                         (r * r).sum(dim=(1, 2, 3))], dim=1)
    assert bool(((got.stats - ref.stats).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("s", [3072, 24576])
def test_attention_partial_kernel_and_combine(s):
    """The kernel's partial form on two halves of the keys, combined,
    against the plain one-shot attention (flagship widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mask3d_tpu_torch.ops import masked_attention as ma

    gen = torch.Generator(device="cuda").manual_seed(s)
    q = torch.randn(8, 25, 128, device="cuda", generator=gen)
    k = torch.randn(8, s, 128, device="cuda", generator=gen)
    v = torch.randn(8, s, 128, device="cuda", generator=gen)
    mask = torch.rand(8, 25, s, device="cuda", generator=gen) < 0.5
    mask[0, 3] = True
    mask[1, 4, :s // 2] = True
    ref = ma.masked_cross_attention_plain(q, k, v, mask, 8)
    h = s // 2
    parts = [ma.masked_cross_attention_partial(
        q, k[:, a:b].contiguous(), v[:, a:b].contiguous(),
        mask[:, :, a:b].contiguous(), 8) for a, b in ((0, h), (h, s))]
    got = ma.combine_partial_softmax(*zip(*parts), 8)
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_segment_sums_bitwise_without_deterministic_mode():
    """The gather paths' segment sums (`sparse.ops._segment_sum_batched`,
    the stride-2 convs and the average pools) add each coarse row's
    children in a fixed order on the card: two calls on a collated batch's
    pooling map are bitwise equal with
    `torch.use_deterministic_algorithms(False)`, and within 1e-5 of a
    float64 sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch.infer import level_capacities
    from mask3d_tpu_torch.sparse.context import build_sparse_batch
    from mask3d_tpu_torch.sparse.ops import _segment_sum_batched

    cfg = mt.apply_overrides(mt.Config(), SMALL)
    dev = mt.collate(_scenes(2), device="cuda",
                     point_bucket_multiple=512).device
    sb = build_sparse_batch(dev.coords, dev.counts, dev.dims,
                            level_capacities(cfg, dev.capacity),
                            dev.grid_dims, build_pool_parents=True)
    pool, cap = sb.pools[0], sb.levels[1].capacity
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(tuple(pool.parent.shape) + (96,), device="cuda",
                    generator=g)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        first = _segment_sum_batched(x, pool, cap)
        again = _segment_sum_batched(x, pool, cap)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(first, again)
    b, _, c = x.shape
    ref = torch.zeros((b, cap + 1, c), dtype=torch.float64)
    ref.scatter_add_(1, pool.parent.long().cpu()[..., None].expand(-1, -1, c),
                     x.double().cpu())
    assert float((first.double().cpu() - ref[:, :cap]).abs().max()) <= 1e-5
