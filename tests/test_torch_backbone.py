"""Res16UNet backbones of the PyTorch port against the JAX package's dense
backbone with the same bridged weights: every returned feature map."""

import jax
import numpy as np
import pytest
import torch

from mask3d_tpu.data import VoxelizeCollate
from mask3d_tpu.models.backbone import BACKBONES as J_BACKBONES
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch.models.backbone import BACKBONES as T_BACKBONES
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from tests.torch_parity import BUCKET, assert_scaled_close, flax_to_numpy, \
    scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

CAP_RATIOS = (0.5, 0.25, 0.125, 0.0625)
# max |diff| / max(1, std) per variant. 14A holds 1e-4. 18A (two blocks a
# stage, twice the InstanceNorms) measured 1.2e-4 on its stride-1 map, where
# the JAX package's own jitted and eager runs already differ by 9.3e-5:
# each norm rescales the rounding of the convs before it, so the bound is
# 2e-4 there.
TOL = {"Res16UNet14A": 1e-4, "Res16UNet18A": 2e-4}


@pytest.mark.parametrize("name", ["Res16UNet14A", "Res16UNet18A"])
def test_backbone_feature_maps_match(name):
    dev = VoxelizeCollate(point_bucket_multiple=BUCKET)(scene_items()).device
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
    gd = dev.grid_dims

    def sb_of(c, n, d):
        return j_build(c, n, d, caps, grid_dims=gd, build_block_maps=False,
                       conv1_kernel_size=None, build_pool_parents=False)

    jbb = J_BACKBONES[name](in_channels=1, conv1_kernel_size=3,
                            impl="dense")
    params = jax.jit(lambda c, n, d, f: jbb.init(
        jax.random.PRNGKey(0), f, sb_of(c, n, d), gd))(
        dev.coords, dev.counts, dev.dims, dev.feats)["params"]
    # non-trivial norm affines, so the bridge's scale/bias mapping shows
    rng = np.random.default_rng(1)
    params = {k: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                  if k.endswith("_scale") else
                  rng.normal(0, 0.2, v.shape).astype(np.float32)
                  if k.endswith("_bias") else np.asarray(v))
              for k, v in flax_to_numpy(params).items()}
    _, ref_maps = jax.jit(lambda p, c, n, d, f: jbb.apply(
        {"params": p}, f, sb_of(c, n, d), gd))(
        params, dev.coords, dev.counts, dev.dims, dev.feats)

    sd = bridge.from_flax({"params": {"backbone": params}})
    tbb = T_BACKBONES[name](in_channels=1, conv1_kernel_size=3)
    tbb.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()},
                        strict=True)
    t = {f: torch.tensor(np.asarray(getattr(dev, f)))
         for f in ("coords", "counts", "dims", "feats")}
    sb = t_build(t["coords"], t["counts"], t["dims"], caps, gd)
    with torch.no_grad():
        out_rows, maps, grid = tbb(t["feats"], sb, gd)
    assert len(maps) == len(ref_maps) == 5
    for i, (r, g) in enumerate(zip(ref_maps, maps)):
        assert_scaled_close(r, g, TOL[name], f"{name} feature map {i}")
    assert out_rows is maps[-1]
    assert tuple(grid.shape) == (dev.coords.shape[0],) + tuple(gd[0]) + (
        maps[-1].shape[-1],)
