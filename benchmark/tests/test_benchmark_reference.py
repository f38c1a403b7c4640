"""The plain reference against the program at a tiny width on the CPU:
the same raw scenes and weights through `mask3d_tpu_torch` (fp32) and
`benchmark/reference/mask3d_plain.py` give the same outputs."""

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import mask3d_plain
from benchmark.tests import tiny


def _program(arch, overrides, params, items, bucket):
    import mask3d_tpu_torch as mt
    from mask3d_tpu_torch.config import Config, apply_overrides

    cfg = apply_overrides(Config(), overrides + [
        f"data.point_bucket_multiple={bucket}"])
    model = mt.build_model(cfg, device="cpu", seed=0)
    model.load_state_dict(params, strict=True)
    host = mt.collate(items, device="cpu", point_bucket_multiple=bucket)
    with torch.no_grad():
        out, overflow = mt.infer(model, host.device, cfg, device="cpu")
    assert not bool(overflow)
    return out, host.device.capacity


def _scenes(n=2, seed=3):
    from benchmark.traffic import scenes

    rng = np.random.default_rng(seed)
    return [scenes.rooms_scene(rng, num_rooms_x=3, num_rooms_y=2,
                               room_size=12, height=6, jitter=0.3,
                               dropout=0.5) for _ in range(n)]


@pytest.mark.parametrize("impl", ["gather", "dense"])
def test_reference_matches_the_program(impl):
    params = weights.draw(tiny.ARCH, 12345, "cpu")
    items = _scenes()
    out, n_cap = _program(tiny.ARCH, tiny.CONFIG["overrides"] + [
        f"model.backbone_impl={impl}"], params, items, 512)
    for i, it in enumerate(items):
        ref = mask3d_plain.forward_scene(
            it["coordinates"], n_cap, tiny.ARCH, params)
        masks, n = ref.masks, ref.n
        # every decoder round's class logits, and the FPS positions exactly
        np.testing.assert_allclose(out.aux_pred_class[:, i].numpy(),
                                   ref.class_rounds.numpy(), atol=1e-4)
        assert torch.equal(out.sampled_coords[i], ref.query_xyz)
        scale = float(masks.std())
        err = (out.pred_masks[i, :n] - masks).abs().max().item() / scale
        assert err < 1e-4, err
        assert float(out.pred_masks[i, n:].abs().max()) == 0.0


def test_reference_matches_a_bottleneck_program():
    """Res16UNet50's blocks (the 101's, 6 deep at level 4) at hidden 32:
    its norms over a few coarse rows amplify f32 rounding to ~3e-3 of
    the std on these scenes (measured), so the tolerance is 1e-2."""
    arch = dict(tiny.ARCH, backbone=dict(
        tiny.ARCH["backbone"], name="Res16UNet50", block="bottleneck",
        expansion=4, planes=[32, 64, 128, 256, 256, 256, 256, 256],
        layers=[2, 3, 4, 6, 2, 2, 2, 2]))
    params = weights.draw(arch, 7, "cpu")
    items = _scenes(1)
    overrides = [o for o in tiny.CONFIG["overrides"]
                 if not o.startswith("model.backbone=")]
    out, n_cap = _program(arch, overrides + [
        "model.backbone=Res16UNet50", "model.backbone_impl=gather"],
        params, items, 512)
    ref = mask3d_plain.forward_scene(
        items[0]["coordinates"], n_cap, arch, params)
    masks, n = ref.masks, ref.n
    err = (out.pred_masks[0, :n] - masks).abs().max().item() / float(
        masks.std())
    assert err < 1e-2, err


@pytest.mark.parametrize("precision,lo,hi", [("fp8", 1e-3, 0.2),
                                              ("tf32", 3e-5, 3e-3)])
def test_lower_numerics_round_every_operand(precision, lo, hi):
    num = mask3d_plain.Numerics(precision)
    x = torch.randn(64, 32)
    w = torch.randn(32, 16)
    got = num.mm(x, w)
    assert not torch.equal(got, x @ w)
    rel = ((got - x @ w).norm() / (x @ w).norm()).item()
    assert lo < rel < hi
