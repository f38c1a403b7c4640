"""`model.unit_features` on the gather impls against the JAX package, whose
gather context reads the features as given and ignores the flag
(mask3d_tpu/models/backbone.py:752-757): Res16UNet14A with the flag on in
both packages, on the same seeded weights (`bridge.to_flax` of the port's
init) and the parity scenes' unit features, at bucket 1024 (levels 0 and 1
take the bf16 sparse conv on `gather_pallas`). `gather` within 1e-4 x
max(1, std) of every feature map (tests/test_torch_gather_path.py's fp32
tolerance); `gather_pallas` within that file's bf16 bounds, JAX's Pallas
conv computed by its function in XLA
(tests/test_torch_bottleneck.py:jax_bf16_conv)."""

import jax
import numpy as np
import pytest
import torch

from mask3d_tpu.data import VoxelizeCollate
from mask3d_tpu.models.backbone import BACKBONES as J_BACKBONES
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.sparse import pallas_conv as j_pallas_conv
from mask3d_tpu_torch import bridge
from mask3d_tpu_torch.models.backbone import BACKBONES as T_BACKBONES
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from tests.test_torch_bottleneck import jax_bf16_conv
from tests.test_torch_gather_path import CAP_RATIOS, GP_BUCKET, \
    assert_within_bf16_bounds
from tests.torch_parity import assert_scaled_close, scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

NAME = "Res16UNet14A"


@pytest.mark.parametrize("impl", ["gather", "gather_pallas"])
def test_unit_features_on_gather_matches_jax(impl, monkeypatch):
    dev = VoxelizeCollate(point_bucket_multiple=GP_BUCKET)(
        scene_items()).device
    rows = (np.arange(dev.coords.shape[1])[None]
            < np.asarray(dev.counts)[:, None])
    assert np.all(np.asarray(dev.feats)[rows] == 1.0)  # unit features
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
    gd = dev.grid_dims
    tbb = T_BACKBONES[NAME](in_channels=1, conv1_kernel_size=3, impl=impl,
                            unit_features=True)
    tbb.init_weights(torch.Generator().manual_seed(0))
    params = bridge.to_flax({f"backbone.{k}": v for k, v in
                             tbb.state_dict().items()})["params"]["backbone"]

    def sb_of(c, n, d):
        return j_build(c, n, d, caps, grid_dims=gd, conv1_kernel_size=3)

    jbb = J_BACKBONES[NAME](in_channels=1, conv1_kernel_size=3, impl=impl,
                            unit_features=True)
    monkeypatch.setattr(j_pallas_conv, "sparse_conv_pallas", jax_bf16_conv)
    _, ref_maps = jax.jit(lambda p, c, n, d, f: jbb.apply(
        {"params": p}, f, sb_of(c, n, d)))(
        params, dev.coords, dev.counts, dev.dims, dev.feats)

    t = [torch.tensor(np.asarray(getattr(dev, f)))
         for f in ("coords", "counts", "dims")]
    sb = t_build(*t, caps, gd, conv1_kernel_size=3, build_block_maps=True,
                 build_pool_parents=True)
    with torch.no_grad():
        _, maps, _ = tbb(torch.tensor(np.asarray(dev.feats)), sb, gd)
    for i, (r, g) in enumerate(zip(ref_maps, maps)):
        if impl == "gather":
            assert_scaled_close(r, g, 1e-4, f"{impl} map {i}")
        else:
            valid = sb.levels[4 - i].valid.numpy()
            assert_within_bf16_bounds(np.asarray(r)[valid], g.numpy()[valid],
                                      f"{impl} map {i}")
