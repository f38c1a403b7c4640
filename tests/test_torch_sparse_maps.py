"""Kernel maps and pool maps of the PyTorch port against the JAX package,
bitwise: `cube_offsets`, the dense row table and the table kernel maps at
k=3 and k=5, the PoolMaps of `downsample_level_dense(with_parent=True)`,
and the whole gather-path `build_sparse_batch`."""

import jax
import numpy as np
import pytest
import torch

from mask3d_tpu.config import apply_overrides as j_apply
from mask3d_tpu.data import VoxelizeCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu.sparse import core as JC
from mask3d_tpu.sparse.dense_ops import downsample_level_dense as j_down
from mask3d_tpu.sparse.dense_ops import occupancy as j_occ
from mask3d_tpu.train.loop import _sb_kwargs as j_sb_kwargs
from mask3d_tpu_torch.config import Config, apply_overrides
from mask3d_tpu_torch.infer import _sb_kwargs as t_sb_kwargs
from mask3d_tpu_torch.sparse import core as TC
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from mask3d_tpu_torch.sparse.dense_ops import downsample_level_dense as \
    t_down
from mask3d_tpu_torch.sparse.dense_ops import occupancy as t_occ
from tests.test_e2e import small_config
from tests.torch_parity import BUCKET, scene_items
from tests.torch_parity import (  # noqa: F401 (autouse fixture)
    one_torch_thread_a_module)

CAP_RATIOS = (0.5, 0.25, 0.125, 0.0625)
LEVEL_FIELDS = ("key", "coords", "valid", "count", "dims")


def _eq(ref, got, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), what)


@pytest.fixture(scope="module")
def batch():
    """One collated batch and its base level in both packages."""
    dev = VoxelizeCollate(point_bucket_multiple=BUCKET)(
        scene_items()).device
    t = {f: torch.tensor(np.asarray(getattr(dev, f)))
         for f in ("coords", "counts", "dims")}
    return dict(dev=dev, t=t,
                j_base=JC.build_base_level(dev.coords, dev.counts, dev.dims),
                t_base=TC.build_base_level(t["coords"], t["counts"],
                                           t["dims"]))


@pytest.mark.parametrize("radius", [1, 2])
def test_cube_offsets_match(radius):
    got = TC.cube_offsets(radius)
    assert got.dtype == torch.int32
    _eq(JC.cube_offsets(radius), got)


@pytest.mark.parametrize("k", [3, 5])
def test_row_table_and_neighbor_map_match(batch, k):
    gd = batch["dev"].grid_dims[0]
    cells = gd[0] * gd[1] * gd[2]
    j_table = JC.build_row_table(batch["j_base"], cells)
    t_table = TC.build_row_table(batch["t_base"], cells)
    assert t_table.dtype == torch.int32
    _eq(j_table, t_table, "row table")
    r = k // 2
    j_idx, j_ok = JC.neighbor_map_table(batch["j_base"], j_table,
                                        JC.cube_offsets(r))
    t_idx, t_ok = TC.neighbor_map_table(batch["t_base"], t_table,
                                        TC.cube_offsets(r))
    assert t_idx.dtype == torch.int32 and t_ok.dtype == torch.bool
    assert t_idx.shape[-1] == k ** 3
    _eq(j_idx, t_idx, "idx")
    _eq(j_ok, t_ok, "ok")
    assert not bool(t_idx[~t_ok].any())  # idx is 0 where ok is false
    # the centre offset of a valid row is the row itself
    centre = t_idx[..., k ** 3 // 2]
    valid = batch["t_base"].valid
    rows = torch.arange(valid.shape[1], dtype=torch.int32).expand_as(valid)
    assert torch.equal(centre[valid], rows[valid])


# (level_cap_ratios, scene): the second overflows the coarse levels, where
# overflowed rows must point at the drop slot
POOLS = [(CAP_RATIOS, None),
         ((0.05, 0.02, 0.01, 0.005),
          dict(num_rooms_x=2, num_rooms_y=2, room_size=10, height=5,
               jitter=0.3, dropout=0.2, multi_floor=True))]


@pytest.mark.parametrize("case", range(len(POOLS)))
def test_downsample_with_parent_matches(case):
    ratios, scene = POOLS[case]
    if scene is None:
        items = scene_items()
    else:
        rng = np.random.default_rng(5)
        items = [j_make(rng, **scene) for _ in range(3)]
    dev = VoxelizeCollate(point_bucket_multiple=BUCKET)(items).device
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in ratios]
    gd = dev.grid_dims
    j_lvl = JC.build_base_level(dev.coords, dev.counts, dev.dims)
    t_lvl = TC.build_base_level(*(torch.tensor(np.asarray(getattr(dev, f)))
                                  for f in ("coords", "counts", "dims")))
    j_o, t_o = j_occ(j_lvl, gd[0]), t_occ(t_lvl, gd[0])
    overflowed = False
    for li, cap in enumerate(caps):
        j_lvl, j_pool, j_o = jax.jit(
            lambda lv, o, gd=gd[li], cap=cap: j_down(lv, gd, cap, occ_f=o)
        )(j_lvl, j_o)
        t_lvl, t_pool, t_o = t_down(t_lvl, gd[li], cap, occ_f=t_o,
                                    with_parent=True)
        for f in LEVEL_FIELDS:
            _eq(getattr(j_lvl, f), getattr(t_lvl, f), f"level {li + 1} {f}")
        for f in ("parent", "kidx", "nchild", "overflow"):
            got = getattr(t_pool, f)
            if f != "overflow":
                assert got.dtype == torch.int32, f
            _eq(getattr(j_pool, f), got, f"pool {li} {f}")
        overflowed |= bool(t_pool.overflow.any())
    assert overflowed == (case == 1)


def test_dense_path_builds_no_parents(batch):
    """Without parents the dense path's PoolMaps carry the overflow flag
    only (its pooled pyramid runs on grids)."""
    gd = batch["dev"].grid_dims
    t = batch["t"]
    sb = t_build(t["coords"], t["counts"], t["dims"], [256, 128, 64, 32], gd)
    assert all(p.parent is None and p.kidx is None and p.nchild is None
               for p in sb.pools)
    assert sb.nbr_idx == () and sb.nbr0_idx is None


@pytest.mark.parametrize("impl,k0", [("gather", 3), ("gather_pallas", 5)])
def test_gather_sparse_batch_matches(batch, impl, k0):
    """`build_sparse_batch` with `_sb_kwargs` of a gather impl: every level,
    PoolMap and kernel map bitwise equal to the JAX package's."""
    ov = [f"model.backbone_impl={impl}", f"model.conv1_kernel_size={k0}"]
    j_cfg = j_apply(small_config(), ov)
    t_cfg = apply_overrides(Config(), ov)
    dev, t = batch["dev"], batch["t"]
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in CAP_RATIOS]
    ref = jax.jit(lambda c, n, d: j_build(
        c, n, d, caps, **j_sb_kwargs(j_cfg, dev.grid_dims)))(
        dev.coords, dev.counts, dev.dims)
    got = t_build(t["coords"], t["counts"], t["dims"], caps, dev.grid_dims,
                  **t_sb_kwargs(t_cfg))
    for li, (rl, gl) in enumerate(zip(ref.levels, got.levels)):
        for f in LEVEL_FIELDS:
            _eq(getattr(rl, f), getattr(gl, f), f"level {li} {f}")
    for li, (rp, gp) in enumerate(zip(ref.pools, got.pools)):
        for f in ("parent", "kidx", "nchild", "overflow"):
            _eq(getattr(rp, f), getattr(gp, f), f"pool {li} {f}")
    assert len(got.nbr_idx) == len(ref.nbr_idx) == 5
    for li in range(5):
        _eq(ref.nbr_idx[li], got.nbr_idx[li], f"nbr_idx {li}")
        _eq(ref.nbr_ok[li], got.nbr_ok[li], f"nbr_ok {li}")
    assert got.nbr0_idx.shape[-1] == k0 ** 3
    _eq(ref.nbr0_idx, got.nbr0_idx, "nbr0_idx")
    _eq(ref.nbr0_ok, got.nbr0_ok, "nbr0_ok")
