"""Post-processing, DBSCAN and the evaluator of the PyTorch port against the
JAX package's numpy versions on the same inputs: identical outputs."""

import numpy as np
import pytest

from mask3d_tpu.evalm import Mask3DEvaluator as JEvaluator
from mask3d_tpu.train.postprocess import postprocess_item as j_post
from mask3d_tpu_torch.evalm import Mask3DEvaluator
from mask3d_tpu_torch.postprocess import dbscan_labels, postprocess_item


def _scene(rng, n_rooms=4, side=10, q=8):
    """Lattice points in rooms along x, GT masks, and noisy per-query
    logits leaning towards one room each."""
    xs = np.stack(np.meshgrid(np.arange(n_rooms * side), np.arange(side),
                              np.arange(3), indexing="ij"), -1).reshape(-1, 3)
    keep = rng.random(len(xs)) < 0.7
    coords = xs[keep].astype(np.float32)
    room = coords[:, 0].astype(int) // side
    gt = np.stack([room == r for r in range(n_rooms)])
    lean = 2.0 * gt[np.arange(q) % n_rooms].T - 1.0
    logits = 3.0 * lean + rng.normal(0, 2.5, size=(len(coords), q))
    pred_class = rng.normal(0, 2, size=(q, 2)).astype(np.float32)
    return coords, gt, logits.astype(np.float32), pred_class


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbscan_labels_match_sklearn(seed):
    """Integer lattices put many distances exactly at eps; clusters, noise
    and border points agree with scikit-learn's DBSCAN."""
    sklearn_cluster = pytest.importorskip("sklearn.cluster")
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 12, size=(400, 3)).astype(np.float32)
    pts[:40] += 30  # a second far blob
    for eps, min_pts in ((1.0, 4), (1.0, 10), (1.5, 6), (2.0, 30)):
        ref = sklearn_cluster.DBSCAN(eps=eps, min_samples=min_pts).fit(
            pts).labels_
        got = dbscan_labels(pts, eps, min_pts)
        np.testing.assert_array_equal(got, ref, (eps, min_pts))


@pytest.mark.parametrize("use_dbscan", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_identical(seed, use_dbscan):
    rng = np.random.default_rng(seed)
    coords, _, logits, pred_class = _scene(rng)
    kw = dict(use_dbscan=use_dbscan, dbscan_eps=1.0, dbscan_min_points=4,
              scores_threshold=0.05)
    ref = j_post(pred_class, logits, coords, "s", **kw)
    got = postprocess_item(pred_class, logits, coords, "s", **kw)
    assert ref.keys() == got.keys()
    for key in ref:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(ref[key]), key)


def test_evaluator_identical():
    rng = np.random.default_rng(4)
    preds, targets = [], []
    for i in range(3):
        coords, gt, logits, pred_class = _scene(rng)
        preds.append(j_post(pred_class, logits, coords, f"s{i}",
                            use_dbscan=False, scores_threshold=0.05))
        targets.append({"labels": np.ones(len(gt), np.int32), "masks": gt})
    ref = JEvaluator().evaluate(preds, targets, "val")
    got = Mask3DEvaluator().evaluate(preds, targets, "val")
    assert ref == got
    assert ref["val_mean_ap_50"] > 0.0
