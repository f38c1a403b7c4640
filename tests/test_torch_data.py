"""Input path of the PyTorch port against the JAX package: synthetic
scenes, collation and the dense-branch sparse pyramid are bit-identical."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from mask3d_tpu.data import VoxelizeCollate as JCollate
from mask3d_tpu.data import make_synthetic_scene as j_make
from mask3d_tpu.sparse import build_sparse_batch as j_build
from mask3d_tpu_torch.data.collate import VoxelizeCollate as TCollate
from mask3d_tpu_torch.data.synthetic import make_synthetic_scene as t_make
from mask3d_tpu_torch.sparse.context import build_sparse_batch as t_build
from mask3d_tpu_torch.sparse.core import pack_keys, unpack_keys


def _items(make, seed, **kw):
    rng = np.random.default_rng(seed)
    return [make(rng, **kw) for _ in range(3)]


SCENES = [
    dict(num_rooms_x=2, num_rooms_y=1, room_size=12, height=6, jitter=0.0,
         dropout=0.5),
    dict(num_rooms_x=2, num_rooms_y=2, room_size=10, height=5, jitter=0.3,
         dropout=0.2, multi_floor=True),
]


@pytest.mark.parametrize("scene", range(len(SCENES)))
def test_synthetic_scenes_identical(scene):
    for a, b in zip(_items(j_make, 7, **SCENES[scene]),
                    _items(t_make, 7, **SCENES[scene])):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))


COLLATE_KW = [
    dict(point_bucket_multiple=512),
    dict(point_bucket_multiple=256, build_targets=False),
    dict(point_bucket_multiple=512, min_grid_dims=(40, 32, 16),
         filter_out_instance_ids=(-1, 0, 2)),
    dict(point_bucket_multiple=512, grid_dims_cap=(20, 20, 8)),
]


@pytest.mark.parametrize("kw", range(len(COLLATE_KW)))
@pytest.mark.parametrize("scene", range(len(SCENES)))
def test_collate_bit_identical(kw, scene):
    items = _items(j_make, 11, **SCENES[scene])
    ref = JCollate(**COLLATE_KW[kw])(items)
    got = TCollate(**COLLATE_KW[kw])(items)
    assert got.device.grid_dims == ref.device.grid_dims
    assert got.scenes == ref.scenes
    for f in ("coords", "counts", "dims", "feats"):
        np.testing.assert_array_equal(getattr(got.device, f),
                                      np.asarray(getattr(ref.device, f)), f)
    for f in ("labels", "masks", "valid", "point_instance_ids"):
        np.testing.assert_array_equal(
            getattr(got.device.target, f),
            np.asarray(getattr(ref.device.target, f)), f)
    np.testing.assert_array_equal(got.raw_coords, ref.raw_coords)


def test_pack_unpack_keys_roundtrip():
    rng = np.random.default_rng(0)
    dims_np = np.array([[9, 8, 7], [5, 11, 3]], np.int32)
    coords = torch.tensor(rng.integers(0, dims_np[:, None, :], (2, 50, 3)),
                          dtype=torch.int32)
    dims = torch.tensor(dims_np)
    keys = pack_keys(coords, dims[:, None, :])
    torch.testing.assert_close(unpack_keys(keys, dims), coords)


# (level_cap_ratios, scene): the second row overflows the coarse levels,
# where truncation drops shipped rows but coarse occupancy pools the
# untruncated grid.
PYRAMIDS = [((0.5, 0.25, 0.125, 0.0625), 0),
            ((0.5, 0.25, 0.125, 0.0625), 1),
            ((0.05, 0.02, 0.01, 0.005), 1)]


@pytest.mark.parametrize("case", range(len(PYRAMIDS)))
def test_sparse_batch_bit_identical(case):
    ratios, scene = PYRAMIDS[case]
    host = JCollate(point_bucket_multiple=512)(
        _items(j_make, 5, **SCENES[scene]))
    dev = host.device
    caps = [max(8, int(dev.coords.shape[1] * r)) for r in ratios]
    ref = jax.jit(lambda c, n, d: j_build(
        c, n, d, caps, grid_dims=dev.grid_dims, build_block_maps=False,
        conv1_kernel_size=None, build_pool_parents=False))(
        dev.coords, dev.counts, dev.dims)
    tdev = TCollate(point_bucket_multiple=512)(
        _items(j_make, 5, **SCENES[scene])).device.to("cpu")
    got = t_build(tdev.coords, tdev.counts, tdev.dims, caps, dev.grid_dims)
    assert len(got.levels) == len(ref.levels) == 5
    for rl, gl in zip(ref.levels, got.levels):
        assert gl.stride == rl.stride
        for f in ("key", "coords", "valid", "count", "dims"):
            np.testing.assert_array_equal(
                getattr(gl, f).numpy(), np.asarray(getattr(rl, f)), f)
    for ro, go in zip(ref.occ, got.occ):
        np.testing.assert_array_equal(go.numpy(), np.asarray(ro))
    for rp, gov in zip(ref.pools, got.overflow):
        np.testing.assert_array_equal(gov.numpy(), np.asarray(rp.overflow))
    overflowed = any(bool(np.asarray(p.overflow).any()) for p in ref.pools)
    assert overflowed == (case == 2)
    assert bool(got.any_overflow()) == overflowed


def test_device_batch_to_keeps_fields():
    host = TCollate(point_bucket_multiple=512)(
        _items(t_make, 2, **SCENES[0]))
    dev = host.device.to("cpu")
    assert dev.grid_dims == host.device.grid_dims
    assert dev.feats_all_ones is host.device.feats_all_ones is True
    for f in dataclasses.fields(dev):
        if f.name in ("target", "grid_dims", "feats_all_ones"):
            continue
        np.testing.assert_array_equal(getattr(dev, f.name).numpy(),
                                      getattr(host.device, f.name))
    assert dev.coords.dtype == torch.int32 and dev.feats.dtype == \
        torch.float32
