"""The port's input path against the JAX package's: the PLY and LAS
readers, the three dataset classes, the native voxelizer and the full
collator (native and numpy), bitwise on numpy-seeded inputs."""

import functools
import os
import random

import numpy as np
import pytest

from mask3d_tpu.data import collate as j_collate
from mask3d_tpu.data import datasets as j_datasets
from mask3d_tpu.data.las import read_las as j_read_las, write_las as j_write_las
from mask3d_tpu.data.ply import read_ply as j_read_ply, write_ply as j_write_ply
from mask3d_tpu_torch import native
from mask3d_tpu_torch.data import collate as p_collate
from mask3d_tpu_torch.data import datasets as p_datasets
from mask3d_tpu_torch.data.las import read_las, write_las
from mask3d_tpu_torch.data.ply import read_ply, write_ply
from tests.test_trainer import write_scene


def _ply_arrays(rng, n=257):
    return {"x": rng.integers(-50, 50, n).astype(np.int32),
            "y": rng.integers(0, 40, n).astype(np.int32),
            "z": rng.normal(size=n).astype(np.float32),
            "type": rng.integers(0, 22, n).astype(np.uint8),
            "room_id": rng.integers(-1, 9, n).astype(np.int16)}


def _assert_dicts_equal(ref: dict, got: dict):
    assert list(ref) == list(got)
    for k in ref:
        r, g = ref[k], got[k]
        if isinstance(r, np.ndarray):
            assert r.dtype == g.dtype and r.shape == g.shape, k
            assert np.array_equal(r, g), k
        else:
            assert r == g, k


@pytest.mark.parametrize("text", [True, False])
def test_ply_round_trip_and_bytes_match_jax(tmp_path, text):
    """The port writes the bytes the JAX package writes, and each reads
    the other's file to the same arrays."""
    arrays = _ply_arrays(np.random.default_rng(1))
    if text:  # the text format keeps integers exact, floats to %.6g
        arrays = {k: v for k, v in arrays.items() if k != "z"}
    mine, theirs = tmp_path / "port.ply", tmp_path / "jax.ply"
    write_ply(str(mine), arrays, text=text)
    j_write_ply(str(theirs), arrays, text=text)
    assert mine.read_bytes() == theirs.read_bytes()
    got = read_ply(str(theirs))
    _assert_dicts_equal(j_read_ply(str(theirs)), got)
    for k, v in arrays.items():
        assert np.array_equal(got[k], v), k


@pytest.mark.parametrize("extras", [False, True])
def test_las_round_trip_and_bytes_match_jax(tmp_path, extras):
    rng = np.random.default_rng(2)
    n = 300
    coords = rng.uniform(-20, 20, (n, 3))
    kw = {}
    if extras:
        kw = dict(extra_dims={"class": rng.integers(0, 3, n).astype(np.int8),
                              "instance": rng.integers(0, 9, n).astype(
                                  np.int16),
                              "score": rng.random(n).astype(np.float32)},
                  rgb=rng.integers(0, 255, (n, 3)).astype(np.uint16),
                  scales=(0.001, 0.001, 0.001))
    mine, theirs = tmp_path / "port.las", tmp_path / "jax.las"
    write_las(str(mine), coords, **kw)
    j_write_las(str(theirs), coords, **kw)
    assert mine.read_bytes() == theirs.read_bytes()
    got = read_las(str(theirs))
    _assert_dicts_equal(j_read_las(str(theirs)), got)
    scale = 0.001 if extras else 1.0
    assert np.abs(got["xyz"] - coords).max() <= scale / 2 + 1e-9
    for k, v in kw.get("extra_dims", {}).items():
        assert np.array_equal(got[k], v)


def _write_root(root, scenes, rng, classes=True):
    for scene in scenes:
        write_scene(root, scene, rng)
        if classes:
            # class 21 (dropped) and 0 (filtered at collation) points
            path = os.path.join(root, scene, "point_cloud_rasterized_150.ply")
            v = read_ply(path)
            v["type"][rng.random(len(v["type"])) < 0.1] = 21
            v["type"][:7] = 0
            write_ply(path, v)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    rng = np.random.default_rng(7)
    stru = str(tmp_path_factory.mktemp("stru3d"))
    _write_root(stru, ["scene_00001", "scene_00002", "scene_00003",
                       "scene_03000", "scene_03001", "scene_03250"], rng)
    valid = os.path.join(stru, "..", "valid_scenes.txt")
    with open(valid, "w") as f:
        f.write("scene_00001\nscene_00003\nscene_03000\nscene_03250\n"
                "scene_09999\n")
    s3dis = str(tmp_path_factory.mktemp("s3dis"))
    _write_root(s3dis, [f"area_{i}" for i in range(1, 7)], rng, False)
    mp3d = str(tmp_path_factory.mktemp("mp3d"))
    _write_root(mp3d, ["17DRP5sb8fy", "1LXtFkjw3qL", "2azQ1b91cZZ"], rng,
                False)
    split_dir = str(tmp_path_factory.mktemp("mp3d_splits"))
    for mode, scenes in (("train", ["17DRP5sb8fy", "1LXtFkjw3qL"]),
                         ("val", ["2azQ1b91cZZ"]),
                         ("test", ["2azQ1b91cZZ"])):
        with open(os.path.join(split_dir, mode), "w") as f:
            f.write("\n".join(scenes) + "\n")
    return dict(structured3d=stru, s3dis=s3dis, matterport3d=mp3d,
                valid=valid, split_dir=split_dir)


AUG = {"structured3d": "stru3d", "s3dis": "s3dis",
       "matterport3d": "matterport3d"}


@pytest.mark.parametrize("name", ["structured3d", "s3dis", "matterport3d"])
@pytest.mark.parametrize("mode", ["train", "validation", "test", "trainval"])
def test_dataset_items_match_jax(roots, name, mode):
    """Every item of every split: the same scenes and arrays bitwise,
    augmentation draws included (one seed), and `data_fraction`'s sample
    under one global `random` seed."""
    kw = dict(data_root=roots[name], mode=mode)
    if mode == "train":
        kw.update(volume_augmentations=AUG[name], augmentation_seed=5,
                  data_fraction=0.5)
    if name == "structured3d" and mode in ("train", "trainval"):
        kw["valid_scenes_file_path"] = roots["valid"]
    if name == "matterport3d" and mode != "trainval":
        kw["split_dir"] = roots["split_dir"]
    random.seed(3)
    ref = j_datasets.DATASETS[name](**kw)
    random.seed(3)
    got = p_datasets.DATASETS[name](**kw)
    assert ref.data == got.data and len(got) > 0
    assert ref.labels_info == got.labels_info
    for i in range(len(ref)):
        _assert_dicts_equal(ref[i], got[i])
    out = np.array([0, 1, 0])
    assert np.array_equal(ref.change_semantic_label_idxs_to_ids(out),
                          got.change_semantic_label_idxs_to_ids(out))


def test_empty_split_is_refused_as_in_jax(roots, tmp_path):
    os.makedirs(tmp_path / "scene_00001")
    for ds in (j_datasets, p_datasets):
        with pytest.raises(AssertionError, match="Empty dataset"):
            ds.Structured3DSegmentationDataset(str(tmp_path), mode="test")


# tests/test_native.py:16-55, on the port's build of the same source
@pytest.mark.parametrize("case", ["random", "duplicates", "huge_sparse"])
def test_native_voxelizer_matches_numpy(case):
    rng = np.random.default_rng(0)
    if case == "random":
        coords = (rng.normal(size=(5000, 3)) * 30).astype(np.float32)
        coords[:, 2] *= 0.2
    elif case == "duplicates":
        base = rng.integers(0, 5, (40, 3)).astype(np.float32)
        coords = np.concatenate([base, base, base])
    else:  # key + index bits > 64: the comparison-sort branch
        coords = rng.uniform(0, 1_000_000, (64, 3)).astype(np.float32)
        coords[1] = coords[0]
    uniq_c, keep_c, dims_c = native.voxelize_native(coords)
    ci = coords.astype(np.int32)
    ci = ci - ci.min(axis=0)
    uniq_np, keep_np = np.unique(ci, axis=0, return_index=True)
    assert np.array_equal(dims_c, uniq_np.max(axis=0) + 1)
    assert np.array_equal(uniq_c, uniq_np)
    assert np.array_equal(keep_c, keep_np)
    if case == "duplicates":
        assert (keep_c < 40).all()
    if case != "huge_sparse":  # past the int32-key contract of collation
        for got, ref in zip(p_collate.voxelize_item(coords),
                            p_collate.voxelize_item(coords,
                                                    use_native=False)):
            assert np.array_equal(got, ref)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_native_build_raises(tmp_path, monkeypatch, compiler):
    """No quiet fallback: a build that fails raises with the compiler's
    output, and the collator does not switch to numpy."""
    if compiler == "missing":
        cxx = str(tmp_path / "no-such-compiler")
        match = "no-such-compiler"
    else:
        cxx = tmp_path / "cxx"
        cxx.write_text("#!/bin/sh\necho 'error: planted failure' >&2\n"
                       "exit 1\n")
        cxx.chmod(0o755)
        match = "planted failure"
    monkeypatch.setattr(native, "CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    coords = np.random.default_rng(0).normal(size=(100, 3)) * 10
    with pytest.raises(RuntimeError, match=match):
        p_collate.voxelize_item(coords)
    items = [{"coordinates": coords, "features": np.ones((100, 1)),
              "labels": np.ones((100, 2), np.int32),
              "raw_coordinates": coords, "raw_features": np.ones((100, 1)),
              "raw_labels": np.ones((100, 2), np.int32), "scene": "s"}] * 2
    with pytest.raises(RuntimeError, match=match):
        p_collate.VoxelizeCollate()(items)
    assert native._lib is None


def _host_arrays(host):
    dev = host.device
    t = dev.target
    return dict(coords=dev.coords, counts=dev.counts, dims=dev.dims,
                feats=dev.feats, labels=t.labels, masks=t.masks,
                valid=t.valid, point_instance_ids=t.point_instance_ids,
                raw_coords=host.raw_coords, raw_feats=host.raw_feats,
                raw_labels=host.raw_labels)


@pytest.fixture(scope="module")
def train_items(roots):
    ds = p_datasets.Structured3DSegmentationDataset(
        roots["structured3d"], mode="train", volume_augmentations="stru3d",
        augmentation_seed=11)
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("kwargs", [
    dict(filter_out_classes=(0, 17, 18, 19, 21)),
    dict(build_targets=False),
    dict(grid_dims_cap=(20, 16, 8), filter_out_classes=(0,)),
    dict(mode="train", small_crops=True, prediction_label_offset=1),
    dict(mode="train", very_small_crops=True, min_grid_dims=(64, 32, 16)),
], ids=["targets", "no_targets", "grid_cap", "small_crops",
        "very_small_crops"])
@pytest.mark.parametrize("use_native", [True, False])
def test_collator_matches_jax(train_items, monkeypatch, kwargs, use_native):
    """The full collator, with the thread pool, against the JAX package's
    on the same items: every array bitwise, scenes and grid dims equal."""
    if not use_native:
        monkeypatch.setattr(p_collate, "voxelize_item", functools.partial(
            p_collate.voxelize_item, use_native=False))
    kw = dict(point_bucket_multiple=256, num_queries=8, **kwargs)
    ref = j_collate.VoxelizeCollate(**kw)(train_items)
    got = p_collate.VoxelizeCollate(**kw)(train_items)
    assert ref.scenes == got.scenes
    assert ref.device.grid_dims == got.device.grid_dims
    r, g = _host_arrays(ref), _host_arrays(got)
    for k in r:
        rk = np.asarray(r[k])
        assert rk.dtype == g[k].dtype and rk.shape == g[k].shape, k
        assert np.array_equal(rk, g[k]), k
    # the crops' guard points carry zero features
    crops = kwargs.get("small_crops") or kwargs.get("very_small_crops")
    assert got.device.feats_all_ones == (not crops)


def test_collator_serial_on_one_core(train_items, monkeypatch):
    """One core: no thread pool, the same batch."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    monkeypatch.setattr(p_collate.VoxelizeCollate, "_get_executor",
                        lambda self: pytest.fail("pool used on one core"))
    got = p_collate.VoxelizeCollate(point_bucket_multiple=256)(train_items)
    ref = j_collate.VoxelizeCollate(point_bucket_multiple=256)(train_items)
    for k, v in _host_arrays(ref).items():
        assert np.array_equal(np.asarray(v), _host_arrays(got)[k]), k
