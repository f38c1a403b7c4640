"""The RoomFormer baseline's ops and host modules: the port against the JAX
package on the same numpy inputs (the deformable sampler, the soft
rasterizer and its vertex gradients, the criterion's losses) and equal
results from the numpy modules (polygon ops, polygonize, floorplan
metrics, the Mask3D bridge, the floor polygons of annotation_3d.json, the
density dataset and its collation)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mask3d_tpu.baseline import criterion2d as j_crit
from mask3d_tpu.baseline import deform_attn as j_da
from mask3d_tpu.baseline import raster as j_raster
from mask3d_tpu.baseline.roomformer import RoomFormerOutput as JOutput
from mask3d_tpu_torch.baseline import criterion2d as t_crit
from mask3d_tpu_torch.baseline import deform_attn as t_da
from mask3d_tpu_torch.baseline import raster as t_raster
from mask3d_tpu_torch.baseline.roomformer import RoomFormerOutput
from tests.torch_roomformer import floorplan_targets
from tests.torch_threads import one_torch_thread_a_module  # noqa: F401

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_bilinear_sample_matches_jax(rng):
    """Locations inside and outside [0, 1] (zeros outside the map), and
    exact pixel centres."""
    n, h, w, c = 3, 5, 7, 4
    value = rng.normal(size=(n, h, w, c)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (n, 60, 2)).astype(np.float32)
    loc[:, :5] = (np.stack([rng.integers(0, w, 5), rng.integers(0, h, 5)],
                           -1) + 0.5) / np.array([w, h])
    got = t_da.bilinear_sample(_t(value), _t(loc)).numpy()
    want = np.stack([np.asarray(j_da.bilinear_sample(jnp.asarray(value[i]),
                                                     jnp.asarray(loc[i])))
                     for i in range(n)])
    assert (np.abs(loc - 0.5) > 0.5).any(-1).sum() > 20
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _deform_inputs(rng, b=2, nh=2, hd=4, q=5, p=3,
                   shapes=((6, 8), (3, 4), (2, 2))):
    total = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, total, nh, hd)).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (b, q, nh, len(shapes), p, 2)).astype(
        np.float32)
    wts = rng.random((b, q, nh, len(shapes), p)).astype(np.float32)
    wts /= wts.sum(axis=(-2, -1), keepdims=True)
    return value, list(shapes), locs, wts


def test_ms_deform_attn_core_matches_jax(rng):
    """The gather form and the `F.grid_sample` form against JAX."""
    value, shapes, locs, wts = _deform_inputs(rng)
    want = np.asarray(j_da.ms_deform_attn_core(
        jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(wts)))
    for fn in (t_da.ms_deform_attn_core, t_da.ms_deform_attn_grid_sample):
        got = fn(_t(value), shapes, _t(locs), _t(wts)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_swapped_sampler_fails_the_grid_sample_check(rng, monkeypatch):
    """The card's independent check (`chip_smoke.py` phase `roomformer`):
    the gather form with x and y swapped in the sampler disagrees with the
    grid_sample form far beyond the tolerance."""
    value, shapes, locs, wts = _deform_inputs(rng)
    args = (_t(value), shapes, _t(locs), _t(wts))
    ref = t_da.ms_deform_attn_grid_sample(*args)
    real = t_da.bilinear_sample
    monkeypatch.setattr(t_da, "bilinear_sample",
                        lambda v, loc: real(v, loc.flip(-1)))
    assert float((t_da.ms_deform_attn_core(*args) - ref).abs().max()) > 1e-2


def _polygons(rng, p=5, k=6, res=16):
    polys = rng.uniform(1.0, res - 1.0, (p, k, 2)).astype(np.float32)
    # a convex square and a padded triangle among the random ones
    polys[0, :4] = [[3.2, 3.1], [12.7, 3.3], [12.6, 12.4], [3.3, 12.8]]
    valid = np.ones((p, k), bool)
    valid[0, 4:] = False
    valid[1, 3:] = False
    valid[2, 5:] = False
    return polys, valid


@pytest.mark.parametrize("mode", ["mask", "boundary", "hard_mask"])
def test_soft_polygon_batch_matches_jax(mode, rng):
    polys, valid = _polygons(rng)
    got = t_raster.soft_polygon_batch(_t(polys), _t(valid), 16, 0.5,
                                      mode).numpy()
    want = np.asarray(jax.jit(j_raster.soft_polygon_batch,
                              static_argnums=(2, 3, 4))(
        jnp.asarray(polys), jnp.asarray(valid), 16, 0.5, mode))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if mode == "hard_mask":
        np.testing.assert_array_equal(got, want)
    one = t_raster.soft_polygon(_t(polys[1]), _t(valid[1]), 16, 0.5, mode)
    np.testing.assert_allclose(one.numpy(), np.asarray(j_raster.soft_polygon(
        jnp.asarray(polys[1]), jnp.asarray(valid[1]), 16, 0.5, mode)),
        rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["mask", "boundary"])
def test_soft_polygon_vertex_gradients_match_jax(mode, rng):
    polys, valid = _polygons(rng)
    w = rng.normal(size=(len(polys), 16, 16)).astype(np.float32)

    def j_loss(p):
        m = j_raster.soft_polygon_batch(p, jnp.asarray(valid), 16, 0.5,
                                        mode)
        return jnp.sum(m * w)

    want = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(polys)))
    leaf = _t(polys).requires_grad_()
    m = t_raster.soft_polygon_batch(leaf, _t(valid), 16, 0.5, mode)
    (got,) = torch.autograd.grad((m * _t(w)).sum(), leaf)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale)
    assert np.abs(want).max() > 1e-2


def test_cyclic_min_l1_matches_jax(rng):
    qp = 6
    src = rng.random((4, 2 * qp)).astype(np.float32)
    tgts = np.zeros((3, 2 * qp), np.float32)
    lengths = np.array([8, 12, 6], np.int32)
    for t, n in zip(tgts, lengths):
        t[:n] = rng.random(n)
    got = t_crit.cyclic_min_l1(_t(src)[:, None], _t(tgts)[None],
                               _t(lengths)[None]).numpy()
    want = np.stack([np.asarray(j_crit.cyclic_min_l1(
        jnp.asarray(src), jnp.asarray(t), int(n)))
        for t, n in zip(tgts, lengths)], 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("raster", [True, False])
def test_criterion_losses_match_jax(raster):
    """Random outputs (3 decoder layers, room classes) and targets with
    padding polygons: every loss, aux layers and the room-class loss
    included, both criteria matching with their default device LSAP."""
    rng = np.random.default_rng(3)
    nl, b, p, qp, ncls = 3, 2, 4, 5, 3
    logits = rng.normal(size=(nl, b, p, qp)).astype(np.float32)
    coords = rng.uniform(0.02, 0.98, (nl, b, p, qp, 2)).astype(np.float32)
    room = rng.normal(size=(b, p, ncls)).astype(np.float32)
    tg = floorplan_targets(rng, b, p, qp, n_valid=[3, 1])
    room_labels = rng.integers(0, ncls - 1, (b, p)).astype(np.int32)
    kw = dict(raster_res=16, use_raster=raster)
    # both criteria at their default, the device LSAP
    want = jax.jit(j_crit.RoomFormerCriterion(**kw))(
        JOutput(jnp.asarray(logits), jnp.asarray(coords), jnp.asarray(room)),
        {k: jnp.asarray(v) for k, v in tg.items()},
        {"labels": jnp.asarray(room_labels)})
    got = t_crit.RoomFormerCriterion(**kw)(
        RoomFormerOutput(_t(logits), _t(coords), _t(room)),
        {k: _t(v) for k, v in tg.items()}, {"labels": _t(room_labels)})
    assert set(got) == set(want)
    assert ("loss_raster_1" in got) == raster
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


# --- the numpy modules: equal to the JAX package's ------------------------

def test_poly_ops_equal(rng):
    from mask3d_tpu.baseline import poly_ops as jp
    from mask3d_tpu_torch.baseline import poly_ops as tp

    for _ in range(5):
        corners = rng.integers(0, 255, 2 * int(rng.integers(3, 9))).astype(
            np.float64)
        np.testing.assert_array_equal(tp.resort_corners(corners.copy()),
                                      jp.resort_corners(corners.copy()))
        np.testing.assert_array_equal(tp.all_cyclic_orders(corners),
                                      jp.all_cyclic_orders(corners))
        assert tp.is_clockwise(corners.reshape(-1, 2)) == \
            jp.is_clockwise(corners.reshape(-1, 2))
    probs = rng.random((6, 10))
    coords = rng.uniform(0.05, 0.95, (6, 10, 2))
    a = tp.extract_room_polygons(probs, coords, min_area=10.0)
    b = jp.extract_room_polygons(probs, coords, min_area=10.0)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    got, want = tp.pad_polygons(a, 10), jp.pad_polygons(b, 10)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _room_masks(rng, n=3, size=64):
    masks = []
    for _ in range(n):
        m = np.zeros((size, size), np.int64)
        for _ in range(2):  # an L or a T of two rectangles
            x0, y0 = rng.integers(2, size // 2, 2)
            x1, y1 = x0 + rng.integers(6, size // 2, 2)
            m[y0:y1, x0:x1] = 1
        masks.append(m)
    return masks


def test_polygonize_equal(rng):
    from mask3d_tpu.baseline import polygonize as jz
    from mask3d_tpu_torch.baseline import polygonize as tz

    for m in _room_masks(rng):
        pa, fa = tz.polygonize_mask(m, 0.01)
        pb, fb = jz.polygonize_mask(m, 0.01)
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(fa, fb)
        chain = tz.trace_outer_contour(m)
        np.testing.assert_array_equal(chain, jz.trace_outer_contour(m))
        assert tz.contour_area(chain) == jz.contour_area(chain)
        np.testing.assert_array_equal(tz.approx_poly_dp(chain, 2.0),
                                      jz.approx_poly_dp(chain, 2.0))


@pytest.mark.parametrize("protocol", ["s3d", "scenecad"])
def test_floorplan_evaluators_equal(protocol, rng):
    from mask3d_tpu.baseline import floorplan_eval as je
    from mask3d_tpu_torch.baseline import floorplan_eval as te

    make = {"s3d": (te.FloorplanEvaluator, je.FloorplanEvaluator),
            "scenecad": (te.SceneCADEvaluator, je.SceneCADEvaluator)}
    evs = [cls() for cls in make[protocol]]
    squares = [np.array([[40, 40], [120, 40], [120, 120], [40, 120]]),
               np.array([[140, 60], [220, 60], [220, 180], [140, 180]])]
    for _ in range(4):
        preds = [s + rng.integers(-12, 13, s.shape) for s in squares]
        preds.append(preds[0] + 30)  # an overlapping prediction
        scenes = [ev.evaluate_scene(preds, squares) for ev in evs]
        assert scenes[0] == scenes[1]
    masks = _room_masks(rng, size=256)
    assert evs[0].evaluate_scene_masks(masks[:2], masks[1:]) == \
        evs[1].evaluate_scene_masks(masks[:2], masks[1:])
    assert evs[0].summarize() == evs[1].summarize()


def test_extract_floor_polygons_equal():
    from mask3d_tpu.preprocess.stru3d import extract_floor_polygons as jx
    from mask3d_tpu_torch.preprocess.stru3d import \
        extract_floor_polygons as tx
    from tests.test_preprocess import make_annotation

    ann = make_annotation()
    got, want = tx(ann), jx(ann)
    assert [(p["semantic_type"], p["room_id"]) for p in got] == \
        [(p["semantic_type"], p["room_id"]) for p in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["coords2d"], b["coords2d"])


@pytest.fixture(scope="module")
def floorplan_root(tmp_path_factory):
    from mask3d_tpu_torch.data.synthetic import write_floorplan_scene

    root = str(tmp_path_factory.mktemp("floorplans"))
    rng = np.random.default_rng(0)
    for scene in ("scene_00000", "scene_00001", "scene_03000",
                  "scene_03250"):
        write_floorplan_scene(root, scene, rng, num_rooms_x=3,
                              num_rooms_y=2, room_size=12, height=6)
    return root


def test_floorplan_dataset_and_collate_equal(floorplan_root):
    from mask3d_tpu.baseline import density_dataset as jd
    from mask3d_tpu_torch.baseline import density_dataset as td

    items = []
    for mod in (td, jd):
        ds = mod.FloorplanDataset(floorplan_root, "train",
                                  num_queries_per_poly=8, max_polys=5)
        items.append([ds[i] for i in range(len(ds))])
    assert len(items[0]) == 2
    for a, b in zip(*items):
        assert a["scene"] == b["scene"]
        np.testing.assert_array_equal(a["density"], b["density"])
        for k in b["targets"]:
            np.testing.assert_array_equal(a["targets"][k], b["targets"][k])
        assert len(a["gt_polys"]) == len(b["gt_polys"]) == 5
        for x, y in zip(a["gt_polys"], b["gt_polys"]):
            np.testing.assert_array_equal(x, y)
    got = td.collate_floorplan(items[0], 6)
    want = jd.collate_floorplan(items[1], 6)
    np.testing.assert_array_equal(got["density"], want["density"])
    for k in want["targets"]:
        np.testing.assert_array_equal(got["targets"][k],
                                      want["targets"][k])
    assert got["scenes"] == want["scenes"]
    with open(os.path.join(floorplan_root, "scene_00000",
                           "annotation_3d.json")) as f:
        assert len(json.load(f)["semantics"]) == 6


def test_mask3d_bridge_equal(floorplan_root, rng):
    from mask3d_tpu.baseline import roomformer_bridge as jb
    from mask3d_tpu.data.datasets import Structured3DSegmentationDataset as J
    from mask3d_tpu.evalm import Mask3DEvaluator as JEval
    from mask3d_tpu_torch.baseline import roomformer_bridge as tb
    from mask3d_tpu_torch.data.datasets import \
        Structured3DSegmentationDataset as T
    from mask3d_tpu_torch.evalm import Mask3DEvaluator as TEval

    item = T(floorplan_root, "test")[0]
    jitem = J(floorplan_root, "test")[0]
    np.testing.assert_array_equal(item["coordinates"], jitem["coordinates"])
    coords = item["coordinates"].astype(np.float64)
    for key in ("min_coords", "max_coords", "image_res"):
        np.testing.assert_array_equal(tb.density_normalization(coords)[key],
                                      jb.density_normalization(coords)[key])
    np.testing.assert_array_equal(tb.points_to_density_map(coords),
                                  jb.points_to_density_map(coords))
    polys = [np.array([[30, 30], [120, 30], [120, 120], [30, 120]]),
             np.array([[130, 40], [230, 40], [230, 200], [130, 200]])
             + rng.integers(-5, 6, (4, 2))]
    a = tb.polygons_to_mask3d_prediction(coords, polys, "s")
    b = jb.polygons_to_mask3d_prediction(coords, polys, "s")
    for k in ("pred_classes", "pred_masks", "pred_scores"):
        np.testing.assert_array_equal(a[k], b[k])
    got = tb.evaluate_roomformer_scene(item, polys, TEval(), "test")
    want = jb.evaluate_roomformer_scene(jitem, polys, JEval(), "test")
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], float):
            np.testing.assert_equal(got[k], want[k], err_msg=k)
