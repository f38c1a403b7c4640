"""The gather backbone paths of the PyTorch port against the JAX package:
Res16UNet14A feature maps on `gather` (fp32) and `gather_pallas` (bf16
sparse conv on eligible levels) with the same bridged weights; the port's
own dense and gather paths on one state_dict; and the small Mask3D slice on
`gather_pallas` through `infer` against the JAX eval forward.

Bucket 1024 puts the scenes at N = 2048, so levels 0 and 1 are eligible
(`supports`) and take the bf16 conv; the fixtures satisfy JAX's window
premise (`all_hit`) there, so JAX runs its kernel and not its bf16-rounded
slow branch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate
from mask3d_tpu.models.backbone import BACKBONES as J_BACKBONES
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.train.loop import _sb_kwargs, init_state, \
    level_capacities as j_caps
from mask3d_tpu_torch import bridge, build_model, collate, infer
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.models.backbone import BACKBONES as T_BACKBONES
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from mask3d_tpu_torch.sparse.sparse_conv import supports
from tests.test_e2e import small_config
from tests.test_torch_sparse_conv import jax_all_hit
from tests.torch_parity import SMALL_OVERRIDES, assert_scaled_close, \
    flax_to_numpy, scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

CAP_RATIOS = (0.5, 0.25, 0.125, 0.0625)
GP_BUCKET = 1024
# |diff| bounds of the JAX package for a bf16 gather-conv backbone
# (tests/test_pallas_conv.py:169-173). Here both sides round the same
# inputs to bf16 and differ by f32 summation order, which flips a few bf16
# roundings; measured, port against JAX: stride-1 map mean 1.0e-3, 99.9%
# quantile 1.6e-2, max 3.5e-2; Mask3D pred_masks mean 4.1e-3, quantile
# 4.1e-2, max 5.2e-2 (pred_class max 6.7e-4).
BF16_BOUNDS = dict(mean=5e-3, q999=5e-2, max=0.3)


def assert_within_bf16_bounds(ref, got, what):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    stats = dict(mean=diff.mean(), q999=np.quantile(diff, 0.999),
                 max=diff.max())
    assert all(stats[k] < v for k, v in BF16_BOUNDS.items()), (what, stats)


def _assert_all_hit(sb):
    """JAX's window premise on every level that takes the bf16 conv."""
    hit = [jax_all_hit(sb.nbr_idx[li].numpy(), sb.nbr_ok[li].numpy(),
                       256, 1024)
           for li in range(sb.num_levels)
           if supports(sb.levels[li].capacity)]
    assert hit and all(hit)


# (impl, bucket, variant, max |diff| / max(1, std)): fp32 as in
# tests/test_torch_backbone.py; None = the bf16 bounds above
BACKBONE_CASES = [("gather", 512, "Res16UNet14A", 1e-4),
                  ("gather", 512, "Res16UNet18A", 2e-4),
                  ("gather_pallas", GP_BUCKET, "Res16UNet14A", None)]


@pytest.mark.parametrize("case", range(len(BACKBONE_CASES)))
def test_gather_backbone_matches_jax(case):
    impl, bucket, name, tol = BACKBONE_CASES[case]
    dev = VoxelizeCollate(point_bucket_multiple=bucket)(scene_items()).device
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
    gd = dev.grid_dims

    def sb_of(c, n, d):
        return j_build(c, n, d, caps, grid_dims=gd, conv1_kernel_size=3)

    jbb = J_BACKBONES[name](in_channels=1, conv1_kernel_size=3, impl=impl)
    params = jax.jit(lambda c, n, d, f: jbb.init(
        jax.random.PRNGKey(0), f, sb_of(c, n, d)))(
        dev.coords, dev.counts, dev.dims, dev.feats)["params"]
    # non-trivial norm affines, so the bridge's scale/bias mapping shows
    rng = np.random.default_rng(1)
    params = {k: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                  if k.endswith("_scale") else
                  rng.normal(0, 0.2, v.shape).astype(np.float32)
                  if k.endswith("_bias") else np.asarray(v))
              for k, v in flax_to_numpy(params).items()}
    _, ref_maps = jax.jit(lambda p, c, n, d, f: jbb.apply(
        {"params": p}, f, sb_of(c, n, d)))(
        params, dev.coords, dev.counts, dev.dims, dev.feats)

    sd = bridge.from_flax({"params": {"backbone": params}})
    tbb = T_BACKBONES[name](in_channels=1, conv1_kernel_size=3, impl=impl)
    tbb.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()},
                        strict=True)
    t = [torch.tensor(np.asarray(getattr(dev, f)))
         for f in ("coords", "counts", "dims")]
    sb = t_build(*t, caps, gd, conv1_kernel_size=3, build_block_maps=True,
                 build_pool_parents=True)
    if impl == "gather_pallas":
        _assert_all_hit(sb)
    with torch.no_grad():
        out_rows, maps, grid = tbb(torch.tensor(np.asarray(dev.feats)), sb,
                                   gd)
    assert grid is None and out_rows is maps[-1]
    assert len(maps) == len(ref_maps) == 5
    for i, (r, g) in enumerate(zip(ref_maps, maps)):
        valid = sb.levels[4 - i].valid.numpy()
        if tol is None:
            assert_within_bf16_bounds(np.asarray(r)[valid], g.numpy()[valid],
                                      f"{name} {impl} map {i}")
        else:
            assert_scaled_close(r, g, tol, f"{name} {impl} map {i}")


def test_port_dense_matches_gather():
    """One state_dict through the port's dense and gather paths (the
    gather convs re-view the dense layout's weights), within the JAX
    package's own dense-vs-gather tolerance (tests/test_model.py:232-239)."""
    host = collate(scene_items(), device="cpu", point_bucket_multiple=512)
    outs = {}
    for impl in ("dense", "gather"):
        cfg = apply_overrides(Config(), SMALL_OVERRIDES
                              + [f"model.backbone_impl={impl}"])
        model = build_model(cfg, device="cpu", seed=0)
        if outs:
            model.load_state_dict(state)
        state = model.state_dict()
        out, overflow = infer(model, host.device, cfg, device="cpu")
        assert not bool(overflow)
        outs[impl] = out
    valid = (torch.arange(host.device.capacity)[None]
             < torch.as_tensor(host.device.counts)[:, None])
    torch.testing.assert_close(outs["gather"].pred_class,
                               outs["dense"].pred_class, rtol=5e-3,
                               atol=5e-3)
    torch.testing.assert_close(outs["gather"].pred_masks[valid],
                               outs["dense"].pred_masks[valid], rtol=5e-3,
                               atol=5e-3)


def test_infer_refuses_a_model_of_another_impl():
    cfg = apply_overrides(Config(), SMALL_OVERRIDES)
    model = build_model(cfg, device="cpu")
    host = collate(scene_items(), device="cpu", point_bucket_multiple=512)
    gcfg = apply_overrides(Config(), SMALL_OVERRIDES
                           + ["model.backbone_impl=gather"])
    with pytest.raises(ValueError, match="backbone_impl"):
        infer(model, host.device, gcfg, device="cpu")


@pytest.fixture(scope="module")
def gp_slice():
    """JAX state and eval outputs of small_config on gather_pallas at
    bucket 1024, and the port's on the bridged weights."""
    ov = ["model.backbone_impl=gather_pallas",
          f"data.point_bucket_multiple={GP_BUCKET}"]
    cfg = j_apply(small_config(), ov)
    host = VoxelizeCollate(point_bucket_multiple=GP_BUCKET)(scene_items())
    dev = host.device
    state, model, _, _ = init_state(cfg, dev)
    caps = j_caps(cfg, dev.coords.shape[1])

    def fwd(params, buffers, coords, counts, dims, feats):
        sb = j_build(coords, counts, dims, caps,
                     **_sb_kwargs(cfg, dev.grid_dims))
        out = model.apply({"params": params, "buffers": buffers}, sb, feats,
                          coords.astype(jnp.float32), True,
                          grid_dims=dev.grid_dims)
        return out.pred_class, out.pred_masks

    ref = [np.asarray(o) for o in jax.jit(fwd)(
        state.params, state.buffers, dev.coords, dev.counts, dev.dims,
        dev.feats)]
    tcfg = apply_overrides(Config(), SMALL_OVERRIDES + ov)
    port = bridge.load_flax(build_model(tcfg, device="cpu"), flax_to_numpy(
        {"params": state.params, "buffers": state.buffers}))
    thost = collate(scene_items(), device="cpu",
                    point_bucket_multiple=GP_BUCKET)
    out, overflow = infer(port, thost.device, tcfg, device="cpu")
    assert not bool(overflow)
    t = thost.device
    sb = t_build(torch.as_tensor(t.coords), torch.as_tensor(t.counts),
                 torch.as_tensor(t.dims), caps, t.grid_dims,
                 conv1_kernel_size=3, build_block_maps=True)
    return dict(ref=ref, got=[out.pred_class.numpy(),
                              out.pred_masks.numpy()],
                counts=np.asarray(dev.counts), sb=sb)


def test_gather_pallas_slice_matches_jax(gp_slice):
    """pred_class and pred_masks of the Mask3D slice within the bf16
    bounds (pred_masks on valid rows)."""
    _assert_all_hit(gp_slice["sb"])
    (rc, rm), (gc, gm) = gp_slice["ref"], gp_slice["got"]
    assert gc.shape == rc.shape and gm.shape == rm.shape
    valid = np.arange(rm.shape[1])[None] < gp_slice["counts"][:, None]
    assert_within_bf16_bounds(rc, gc, "pred_class")
    assert_within_bf16_bounds(rm[valid], gm[valid], "pred_masks")
