"""The port's data preparation (`mask3d_tpu_torch/preprocess/`,
`utils/kfold.py`, `utils/visualize.py`) against the JAX package's on the
same seeded inputs: arrays, written files (byte for byte) and command-line
output must be equal. Fixtures follow tests/test_preprocess.py."""

import contextlib
import io
import json
import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

from mask3d_tpu_torch.data.synthetic import (
    floorplan_annotation,
    panorama_rooms,
    write_panorama_scene,
)
from mask3d_tpu_torch.preprocess import (
    analyze as p_analyze,
    downsample as p_down,
    geometry as p_geo,
    matterport as p_mp,
    stru3d as p_stru,
)

SQUARE = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], float)
L_SHAPE = np.array([[0, 0], [10, 0], [10, 4], [4, 4], [4, 10], [0, 10]],
                   float)


def _same_arrays(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_arrays(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_arrays(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _same_files(dir_a, dir_b, names):
    for n in names:
        a, b = os.path.join(dir_a, n), os.path.join(dir_b, n)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), n


def _report(out, root):
    """A command's report without the frames of a failure's traceback
    (they name each package's own files), the data root as `<root>`."""
    return [ln.replace(root, "<root>") for ln in out.splitlines()
            if not ln.startswith((" ", "Traceback"))]


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    return buf.getvalue(), ret


@pytest.mark.parametrize("poly", ["square", "l_shape", "reversed_l"])
def test_geometry_matches_jax(poly):
    from mask3d_tpu.preprocess import geometry as j_geo

    p = {"square": SQUARE, "l_shape": L_SHAPE,
         "reversed_l": L_SHAPE[::-1].copy()}[poly]
    rng = np.random.default_rng(0)
    pts = rng.uniform(-3, 13, (500, 2))
    pts[:4] = [[2, 2], [8, 8], [10, 5], [-0.5, 3]]  # notch, edge, near
    assert p_geo.polygon_area(p) == j_geo.polygon_area(p)
    _same_arrays(p_geo.points_in_polygon(pts, p),
                 j_geo.points_in_polygon(pts, p))
    _same_arrays(p_geo.points_to_polygon_distance(pts, p),
                 j_geo.points_to_polygon_distance(pts, p))
    for buffer, chunk in ((0.0, 200_000), (1.5, 200_000), (1.5, 37)):
        _same_arrays(p_geo.points_match_polygon(pts, p, buffer, chunk),
                     j_geo.points_match_polygon(pts, p, buffer, chunk))


@pytest.mark.parametrize("random_level", [0.0, 30.0])
def test_unproject_matches_jax(random_level):
    from mask3d_tpu.preprocess import stru3d as j_stru

    rng = np.random.default_rng(1)
    depth = rng.integers(300, 9000, (64, 128)).astype(np.uint16)
    center = np.array([1234.5, -200.0, 1400.0])
    got = p_stru.unproject_panorama(depth, center, random_level,
                                    np.random.default_rng(7))
    want = j_stru.unproject_panorama(depth, center, random_level,
                                     np.random.default_rng(7))
    assert len(got) < depth.size  # the 500 mm cutoff dropped some
    _same_arrays(got, want)


def _priority_polygons():
    """tests/test_preprocess.py's bedroom / door / invalid sliver, plus a
    kitchen overlapping the door."""
    sq = lambda x0, y0, x1, y1: np.array(  # noqa: E731
        [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], float)
    return [
        {"coords2d": sq(0, 0, 100, 100), "semantic_type": "bedroom",
         "room_id": 1},
        {"coords2d": sq(90, 40, 130, 60), "semantic_type": "door",
         "room_id": 0},
        {"coords2d": sq(200, 0, 210, 10), "semantic_type": "invalid",
         "room_id": 0},
        {"coords2d": sq(140, 45, 300, 70), "semantic_type": "kitchen",
         "room_id": 2},
    ]


def test_label_points_matches_jax():
    from mask3d_tpu.preprocess import stru3d as j_stru

    polys = _priority_polygons()
    rng = np.random.default_rng(2)
    pts = np.concatenate([
        np.array([[50, 50], [95, 50], [120, 50], [205, 5], [500, 500],
                  [127, 45], [100.01, 50]], float),
        rng.uniform(-20, 320, (400, 2))])
    got = p_stru.label_points(pts, polys)
    _same_arrays(got, j_stru.label_points(pts, polys))
    assert got[0][:6].tolist() == [3, 3, 17, 21, 0, 2]
    # two rooms of different types that overlap: both sides raise
    clash = polys[:1] + [dict(polys[3], coords2d=polys[0]["coords2d"] + 50)]
    for fn in (p_stru.label_points, j_stru.label_points):
        with pytest.raises(ValueError, match="conflicting"):
            fn(pts, clash)


def test_extract_and_constants_match_jax():
    from mask3d_tpu.preprocess import stru3d as j_stru

    ann = floorplan_annotation(panorama_rooms() + [
        (20000, 0, 21500, 1500, "undefined"),  # 2.25 m^2 -> other
        (22000, 0, 22500, 500, "undefined")])  # 0.25 m^2 -> invalid
    _same_arrays(p_stru.extract_floor_polygons(ann),
                 j_stru.extract_floor_polygons(ann))
    for name in ("SEMANTIC_TYPE_INT_MAP", "NO_ROOM_ID_TYPES",
                 "LOWER_PRIORITY_TYPES", "POLYGON_BUFFER_MM",
                 "MIN_OTHER_AREA_MM2", "MIN_DEPTH_MM", "ROOM_ID_INVALID"):
        assert getattr(p_stru, name) == getattr(j_stru, name), name


def _cv2_writer(path, depth):
    import cv2

    assert cv2.imwrite(path, depth)


@pytest.fixture(scope="module")
def stru3d_roots(tmp_path_factory):
    """Two raw scenes of 3x2 rooms (64x128 panoramas written by OpenCV)
    and one without annotations, converted by each package's `main`:
    (port root, JAX root, port stdout, JAX stdout, port results)."""
    from mask3d_tpu.preprocess import stru3d as j_stru

    base = tmp_path_factory.mktemp("stru3d")
    port = str(base / "port")
    for i, scene in enumerate(("scene_03250", "scene_03251")):
        write_panorama_scene(port, scene, panorama_rooms(3, 2 - i),
                             pano_hw=(64, 128), write_png=_cv2_writer)
    os.makedirs(os.path.join(port, "scene_03252", "2D_rendering"))
    jax_root = str(base / "jax")
    shutil.copytree(port, jax_root)
    out_p, results = _stdout(p_stru.main, ["--data_root", port])
    out_j, _ = _stdout(j_stru.main, ["--data_root", jax_root])
    return port, jax_root, out_p, out_j, results


def test_panorama_scenes_match_jax(stru3d_roots):
    """The port reads OpenCV's PNGs without OpenCV; the labelled clouds,
    `run_valid_scenes.txt` and the report equal JAX's byte for byte."""
    port, jax_root, out_p, out_j, results = stru3d_roots
    for scene in ("scene_03250", "scene_03251"):
        _same_files(os.path.join(port, scene), os.path.join(jax_root, scene),
                    ["point_cloud.ply", "point_cloud.las"])
    _same_files(port, jax_root, ["run_valid_scenes.txt"])
    with open(os.path.join(port, "run_valid_scenes.txt")) as f:
        assert f.read() == "scene_03250\nscene_03251\n"
    assert _report(out_p, port) == _report(out_j, jax_root)
    assert _report(out_p, port)[-1] == "2 scenes converted, 1 failed"
    assert [r["success"] for r in results] == [True, True, False]
    assert set(results[0]["timings"]) == {"read", "unproject", "label",
                                          "unique"}


def test_panorama_scene_labels_rooms(stru3d_roots):
    """Each room's points carry its id and type; the door loses to the
    rooms it overlaps; coordinates sit on the 10 mm / 100 mm grid."""
    from mask3d_tpu_torch.data.ply import read_ply

    port = stru3d_roots[0]
    v = read_ply(os.path.join(port, "scene_03250", "point_cloud.ply"))
    xy = np.stack([v["x"], v["y"]], 1).astype(np.float64)
    rooms = panorama_rooms(3, 2)
    for r, (x0, y0, x1, y1, sem) in enumerate(rooms[:-1]):
        inside = p_geo.points_in_polygon(
            xy, np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], float))
        assert inside.sum() > 100
        assert (v["room_id"][inside] == r + 1).all()
        assert (v["type"][inside] == p_stru.SEMANTIC_TYPE_INT_MAP[sem]).all()
    assert set(np.unique(v["room_id"]).tolist()) == set(range(1, 7))
    assert np.all(v["x"] % 10 == 0) and np.all(v["z"] % 100 == 0)


def _write_cloud(path, rng, n=3000):
    from mask3d_tpu_torch.data.ply import write_ply

    c = rng.uniform(-4000, 4000, (n, 3)).astype(np.float32)
    write_ply(path, {"x": c[:, 0], "y": c[:, 1], "z": c[:, 2],
                     "type": rng.integers(0, 22, n).astype(np.int32),
                     "room_id": rng.integers(0, 9, n).astype(np.int32)})


def test_downsample_matches_jax_and_bruteforce():
    from mask3d_tpu.preprocess import downsample as j_down

    rng = np.random.default_rng(3)
    n = 2000
    coords = rng.uniform(-5000, 5000, (n, 3))
    types = rng.integers(0, 21, n).astype(np.int32)
    rooms = rng.integers(0, 9, n).astype(np.int32)
    for vs in (100, 150, 200):
        got = p_down.downsample_point_cloud(coords, types, rooms, vs)
        _same_arrays(got, j_down.downsample_point_cloud(coords, types,
                                                        rooms, vs))
        cuboid, sparse = got
        # brute force: first point of each voxel in key order
        vox = np.floor((coords - coords.min(0)) / vs).astype(np.int64)
        first = {}
        for i, v in enumerate(map(tuple, vox)):
            first.setdefault(v, i)
        keep = np.array([first[v] for v in sorted(first)])
        assert np.array_equal(sparse["type"], types[keep])
        assert np.array_equal(sparse["x"], vox[keep, 0] + vox[keep, 0].min())
        assert np.array_equal(cuboid[tuple(vox[keep].T)][:, 1], rooms[keep])


def test_downsample_main_matches_jax(tmp_path):
    """`main` with --scene, --scenes_file and a failing scene: the written
    .npy/.ply/.las and the report equal JAX's."""
    from mask3d_tpu.preprocess import downsample as j_down

    rng = np.random.default_rng(4)
    port = str(tmp_path / "port")
    for s in ("scene_00000", "scene_00001"):
        os.makedirs(os.path.join(port, s))
        _write_cloud(os.path.join(port, s, "point_cloud.ply"), rng)
    os.makedirs(os.path.join(port, "scene_00002"))  # no cloud: fails
    with open(os.path.join(port, "scenes.txt"), "w") as f:
        f.write("scene_00001\n\n")
    jax_root = str(tmp_path / "jax")
    shutil.copytree(port, jax_root)
    for args in (["--voxel_size", "100"], ["--voxel_size", "200",
                                           "--scene", "scene_00000"],
                 ["--scenes_file", None]):
        outs = []
        for root, fn in ((port, p_down.main), (jax_root, j_down.main)):
            a = [os.path.join(root, "scenes.txt") if x is None else x
                 for x in args]
            out, _ = _stdout(fn, ["--data_root", root] + a)
            outs.append(_report(out, root))
        assert outs[0] == outs[1], args
    for s, sizes in (("scene_00000", (100, 200)),
                     ("scene_00001", (100, 150))):
        _same_files(os.path.join(port, s), os.path.join(jax_root, s),
                    [f"point_cloud_rasterized_{vs}.{e}" for vs in sizes
                     for e in ("npy", "ply", "las")])
    assert outs[0][-1] == "1 scenes downsampled, 0 failed"


def test_downsample_native_matches_jax_and_numpy():
    """The bound C++ `downsample_f64` against the JAX package's binding
    of the same function and numpy's quantize + unique."""
    from mask3d_tpu import native as j_native

    from mask3d_tpu_torch import native

    rng = np.random.default_rng(5)
    coords = rng.uniform(-5000, 5000, (20000, 3))
    coords[:100] = coords[100:200]  # duplicates: the first index wins
    for vs in (100.0, 150.0, 200.0):
        vox, keep = native.downsample_native(coords, vs)
        q = np.floor((coords - coords.min(0)) / vs).astype(np.int64)
        u, k = np.unique(q, axis=0, return_index=True)
        assert vox.dtype == np.int32 and keep.dtype == np.int32
        assert np.array_equal(vox, u) and np.array_equal(keep, k)
        jv, jk = j_native.downsample_native(coords, vs)
        assert np.array_equal(vox, jv) and np.array_equal(keep, jk)
    with pytest.raises(ValueError):
        native.downsample_native(coords[:, :2], 100.0)


def _write_regions(d, rng, n_regions, rgb):
    from mask3d_tpu_torch.data.ply import write_ply

    os.makedirs(d, exist_ok=True)
    for i in range(n_regions):
        n = 40 + i
        rec = {k: rng.normal(size=n).astype(np.float32) for k in "xyz"}
        if rgb[i]:
            for k in ("red", "green", "blue"):
                rec[k] = rng.integers(0, 255, n).astype(np.uint8)
        write_ply(os.path.join(d, f"region{i}.ply"), rec, text=False)
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("not a region\n")


def test_matterport_merge_matches_jax(tmp_path):
    """Merged clouds (RGB kept only when every region has it), the
    written .ply/.las and the merge-mode report equal JAX's."""
    from mask3d_tpu.preprocess import matterport as j_mp

    rng = np.random.default_rng(6)
    src = tmp_path / "scans"
    _write_regions(str(src / "scanA" / "region_segmentations"), rng, 3,
                   [True] * 3)
    _write_regions(str(src / "scanB"), rng, 2, [True, False])
    for scan in ("scanA", "scanB"):
        d = src / scan
        if scan == "scanA":
            d = d / "region_segmentations"
        got = p_mp.merge_regions(str(d))
        _same_arrays(got, j_mp.merge_regions(str(d)))
        assert ("rgb" in got) == (scan == "scanA")
        assert set(np.unique(got["room_ids"]).tolist()) == set(
            range(1, 4 if scan == "scanA" else 3))
    outs = {}
    for name, fn in (("port", p_mp.main), ("jax", j_mp.main)):
        outs[name], _ = _stdout(fn, ["--data_root", str(src), "--out_root",
                                     str(tmp_path / name)])
    assert outs["port"] == outs["jax"] == "2 scans merged, 0 failed\n"
    for scan in ("scanA", "scanB"):
        _same_files(str(tmp_path / "port" / scan),
                    str(tmp_path / "jax" / scan),
                    ["point_cloud.ply", "point_cloud.las"])


def test_matterport_download_driver_matches_jax(tmp_path):
    """tests/test_preprocess.py's stub `download_mp.py` (it copies a
    prepared zip; nothing is downloaded): the same .las as JAX's, the temp
    download removed, a rerun skipped, an unknown scan refused."""
    from mask3d_tpu.preprocess import matterport as j_mp

    rng = np.random.default_rng(7)
    payload = tmp_path / "payload" / "scanA" / "region_segmentations"
    _write_regions(str(payload), rng, 2, [True, True])
    zip_src = tmp_path / "region_segmentations.zip"
    with zipfile.ZipFile(zip_src, "w") as z:
        for p in sorted(payload.glob("region*.ply")):
            z.write(p, f"scanA/region_segmentations/{p.name}")
    stub = tmp_path / "download_mp.py"
    stub.write_text(f"""
import os, shutil
BASE_URL = "http://example.invalid/"
RELEASE = "v1"
def get_release_scans(release_file):
    return ["scanA", "scanB"]
def download_scan(scan_id, out_dir, file_types):
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy({str(zip_src)!r},
                os.path.join(out_dir, "region_segmentations.zip"))
""")
    for name, mod in (("port", p_mp), ("jax", j_mp)):
        out = str(tmp_path / name)
        res = mod.download_and_preprocess(out, "scanA", str(stub))
        assert res == [{"scene": "scanA", "success": True}], name
        assert not os.path.exists(os.path.join(out, "temp", "v1", "scanA"))
        assert mod.download_and_preprocess(out, "scanA", str(stub)) == [
            {"scene": "scanA", "success": True, "skipped": True}]
        with pytest.raises(ValueError, match="invalid scan id"):
            mod.download_and_preprocess(out, "nope", str(stub))
    _same_files(str(tmp_path / "port" / "preprocessed" / "v1" / "scanA"),
                str(tmp_path / "jax" / "preprocessed" / "v1" / "scanA"),
                ["point_cloud.las"])
    bad = tmp_path / "not_mp.py"
    bad.write_text("BASE_URL = 'x'\n")
    with pytest.raises(AttributeError, match="RELEASE"):
        p_mp.load_download_mp(str(bad))
    out, _ = _stdout(p_mp.main, ["--out_root", str(tmp_path / "main"),
                                 "--download_mp", str(stub), "--id",
                                 "scanA"])
    assert out == "1 scans done, 0 failed\n"


def test_analyze_matches_jax(tmp_path):
    from mask3d_tpu.preprocess import analyze as j_analyze

    root = tmp_path / "data"
    extra = [[], [(20000, 0, 21500, 1500, "undefined")],
             [(20000, 0, 20500, 500, "undefined"),
              (22000, 0, 23500, 1500, "undefined")]]
    for i, more in enumerate(extra):
        d = root / f"scene_{i:05d}"
        os.makedirs(d)
        with open(d / "annotation_3d.json", "w") as f:
            json.dump(floorplan_annotation(panorama_rooms(1 + i, 2) + more),
                      f)
    os.makedirs(root / "scene_00009")  # no annotation: skipped
    stats = [p_analyze.analyze_scene(str(root / f"scene_{i:05d}"))
             for i in range(3)]
    _same_arrays(stats, [j_analyze.analyze_scene(
        str(root / f"scene_{i:05d}")) for i in range(3)])
    assert [s["num_other"] for s in stats] == [0, 1, 1]
    _same_arrays(p_analyze.aggregate(stats), j_analyze.aggregate(stats))
    _same_arrays(p_analyze.aggregate([]), j_analyze.aggregate([]))
    outs = []
    for name, fn in (("port", p_analyze.main), ("jax", j_analyze.main)):
        out, _ = _stdout(fn, ["--data_root", str(root), "--out",
                              str(tmp_path / f"{name}.txt")])
        outs.append(out)
    assert outs[0] == outs[1] and "skipping scene_00009" in outs[0]
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text()


@pytest.mark.parametrize("k,seed", [(2, 0), (3, 1), (5, 42)])
def test_kfold_matches_jax(k, seed):
    from mask3d_tpu.utils.kfold import kfold_splits as j_kfold

    from mask3d_tpu_torch.utils.kfold import kfold_splits

    scenes = [f"scene_{i:05d}" for i in range(0, 37, 2)]
    got = kfold_splits(scenes, k, seed)
    assert got == j_kfold(scenes, k, seed)
    for train, val in got:
        assert sorted(train + val) == scenes


def test_gradient_flow_stats_matches_jax():
    """A nested dict of gradients gives JAX's names and numbers; a module
    gives its parameters' names, skipping those without a gradient."""
    import jax.numpy as jnp

    from mask3d_tpu.utils.visualize import gradient_flow_stats as j_stats

    from mask3d_tpu_torch.utils.visualize import gradient_flow_stats

    rng = np.random.default_rng(8)
    tree = {"params": {"b": {"kernel": rng.normal(size=(3, 4))},
                       "a": {"bias": rng.normal(size=4),
                             "scale": rng.normal(size=(2, 2))}},
            "batch_stats": {"mean": rng.normal(size=5)}}
    tree = {k: {m: ({n: x.astype(np.float32) for n, x in v.items()}
                    if isinstance(v, dict) else v.astype(np.float32))
                for m, v in g.items()} for k, g in tree.items()}
    as_torch = {k: {m: ({n: torch.tensor(x) for n, x in v.items()}
                        if isinstance(v, dict) else torch.tensor(v))
                    for m, v in g.items()} for k, g in tree.items()}
    want = j_stats({k: {m: ({n: jnp.asarray(x) for n, x in v.items()}
                            if isinstance(v, dict) else jnp.asarray(v))
                        for m, v in g.items()} for k, g in tree.items()})
    got = gradient_flow_stats(as_torch)
    assert list(got) == list(want) and got == want
    assert gradient_flow_stats(tree) == want

    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    model[0].bias.requires_grad_(False)
    model(torch.ones(5, 3)).square().sum().backward()
    stats = gradient_flow_stats(model)
    assert list(stats) == ["0.weight", "1.weight", "1.bias"]
    g = np.abs(model[1].weight.grad.numpy())  # numpy's sums, as JAX's
    assert stats["1.weight"] == {"mean_abs": float(g.mean()),
                                 "max_abs": float(g.max())}


def test_plots_write_pngs(tmp_path):
    """Each plot writes a PNG (RGBA, which the depth reader refuses)."""
    from mask3d_tpu_torch.preprocess.png import PNGError, read_png
    from mask3d_tpu_torch.utils import visualize as vis

    rng = np.random.default_rng(9)
    coords = rng.uniform(0, 10, (300, 3))
    ids = rng.integers(0, 5, 300)
    paths = [
        vis.plot_point_cloud(coords, ids, str(tmp_path / "pc.png"),
                             max_points=100, title="t"),
        vis.plot_prediction_vs_gt(coords, ids, ids[::-1],
                                  str(tmp_path / "pg.png")),
        vis.plot_gradient_flow({"w": torch.ones(3), "b": torch.full((2,), 2.)},
                               str(tmp_path / "gf.png")),
        vis.plot_floorplan([np.array([10, 10, 100, 10, 100, 80])],
                           [[(5, 5), (90, 5), (90, 90)]],
                           str(tmp_path / "fp.png")),
    ]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
        with pytest.raises(PNGError, match="colour type 6"):
            read_png(p)
