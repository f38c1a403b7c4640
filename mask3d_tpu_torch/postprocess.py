"""Prediction post-processing: scoring, DBSCAN filtering, overlap dedup.

A copy of the JAX package's numpy post-processing
(mask3d_tpu/train/postprocess.py:24-215). DBSCAN runs on scipy
(`dbscan_labels`) with the clustering of scikit-learn's DBSCAN.

Rebuild of the reference eval-step post-processing
(`mask3d/trainer/trainer.py:373-524`):
1. softmax over class logits, drop the ignore class (ref :434)
2. optional DBSCAN clustering per mask, keeping clustered points (ref :51-98)
3. top-k scoring: score = class_prob * mean sigmoid heatmap over the
   binarized mask (ref get_mask_and_scores :373-402)
4. sort predictions by score (ref :404-413)
5. optional score-threshold + pairwise-overlap filtering (ref :479-521)

Runs host-side in numpy (the reference also detaches to CPU here, ref
:422-423); the arrays per item are small (N x Q). Called with the padding
already stripped.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from mask3d_tpu_torch.utils import meter


# from mask3d_tpu/train/postprocess.py:24 softmax_excl_ignore
def softmax_excl_ignore(pred_class: np.ndarray) -> np.ndarray:
    """[Q, C+1] logits -> [Q, C] probabilities excluding the ignore class."""
    e = np.exp(pred_class - pred_class.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    return p[..., :-1]


def dbscan_labels(points: np.ndarray, eps: float, min_points: int):
    """DBSCAN cluster labels (-1 = noise), as scikit-learn's
    `DBSCAN(eps, min_samples=min_points)` labels them: a core point has at
    least `min_points` points (itself included) within distance <= eps;
    clusters are the connected components of core points, numbered in the
    order of their first core point; a border point joins the lowest
    numbered cluster among its core neighbours."""
    n = len(points)
    pairs = cKDTree(np.asarray(points, np.float64)).query_pairs(
        eps, output_type="ndarray")
    i, j = pairs[:, 0], pairs[:, 1]
    deg = 1 + np.bincount(i, minlength=n) + np.bincount(j, minlength=n)
    core = deg >= min_points
    labels = np.full(n, -1, np.int64)
    if not core.any():
        return labels
    both = core[i] & core[j]
    graph = coo_matrix((np.ones(both.sum()), (i[both], j[both])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    core_idx = np.flatnonzero(core)
    _, first = np.unique(comp[core_idx], return_index=True)
    order = np.argsort(first)  # components by their first core point
    cluster_of_comp = np.empty(comp.max() + 1, np.int64)
    cluster_of_comp[np.unique(comp[core_idx])[order]] = np.arange(len(order))
    labels[core] = cluster_of_comp[comp[core]]
    # border points: the lowest cluster among their core neighbours
    for a, b in ((i, j), (j, i)):
        sel = core[b] & ~core[a]
        if sel.any():
            cand = labels[b[sel]]
            best = np.full(n, np.iinfo(np.int64).max)
            np.minimum.at(best, a[sel], cand)
            hit = best != np.iinfo(np.int64).max
            labels[hit] = np.where(labels[hit] == -1, best[hit],
                                   np.minimum(labels[hit], best[hit]))
    return labels


# from mask3d_tpu/train/postprocess.py:31 dbscan_filter_masks
def dbscan_filter_masks(pred_masks: np.ndarray, coords: np.ndarray,
                        eps: float, min_points: int) -> np.ndarray:
    """Zero out non-clustered points of each positive mask (ref :51-98).

    pred_masks: [N, Q] logits (modified copy returned); coords: [N, 3].
    For every mask, DBSCAN clusters its positive points; points in no
    cluster (label -1) are removed from the mask (logits zeroed — the
    binarization threshold is > 0, ref :392).
    """
    out = pred_masks.copy()
    for q in range(out.shape[1]):
        sel = out[:, q] > 0
        if not sel.any():
            continue
        labels = dbscan_labels(coords[sel], eps, min_points)
        # Reference semantics (trainer.py:86-92): the mask logits are
        # multiplied by EACH cluster's indicator in sequence, so
        #   0 clusters (all noise) -> mask kept unchanged,
        #   1 cluster             -> only that cluster's points survive,
        #   >=2 clusters          -> the whole mask is zeroed (the
        #                            indicators are disjoint).
        clusters = np.unique(labels[labels >= 0])
        if clusters.size == 0:
            continue
        if clusters.size == 1:
            keep = np.zeros(out.shape[0], bool)
            keep[np.nonzero(sel)[0][labels == clusters[0]]] = True
            out[:, q] = np.where(keep, out[:, q], 0.0)
        else:
            out[:, q] = 0.0
    return out


# from mask3d_tpu/train/postprocess.py:68 get_mask_and_scores
def get_mask_and_scores(pred_probs: np.ndarray, pred_masks: np.ndarray,
                        topk_per_image: int = -1):
    """Reference `get_mask_and_scores` (`trainer.py:373-402`).

    pred_probs: [Q, C] post-softmax class probabilities (ignore dropped);
    pred_masks: [N, Q] logits. Returns (scores f[K], masks bool[N, K],
    classes i[K], heatmap f[N, K]).
    """
    q, c = pred_probs.shape
    k = q if topk_per_image == -1 else topk_per_image
    flat = pred_probs.reshape(-1)
    top = np.argsort(-flat, kind="stable")[:k]
    cls_scores = flat[top]
    labels = top % c
    query_idx = top // c
    masks_logits = pred_masks[:, query_idx]
    bin_masks = masks_logits > 0
    # Stable sigmoid (large negative logits overflow np.exp(-x)).
    heatmap = np.where(
        masks_logits >= 0,
        1.0 / (1.0 + np.exp(-np.clip(masks_logits, 0, None))),
        np.exp(np.clip(masks_logits, None, 0))
        / (1.0 + np.exp(np.clip(masks_logits, None, 0))),
    )
    mask_scores = (heatmap * bin_masks).sum(0) / (bin_masks.sum(0) + 1e-6)
    return cls_scores * mask_scores, bin_masks, labels, heatmap


# from mask3d_tpu/train/postprocess.py:96 sort_by_score
def sort_by_score(scores, masks, classes, heatmap):
    """Descending score sort (reference `trainer.py:404-413`)."""
    order = np.argsort(-scores, kind="stable")
    return (
        classes[order],
        masks[:, order],
        scores[order],
        heatmap[:, order],
    )


# from mask3d_tpu/train/postprocess.py:107 filter_instances
def filter_instances(sorted_masks: np.ndarray, sort_scores: np.ndarray,
                     scores_threshold: float, iou_threshold: float):
    """Score-threshold + normalized-overlap dedup (reference
    `trainer.py:479-510`): among overlapping masks keep the highest-score
    (lowest index) one. Returns kept column indices (ascending)."""
    keep = set()
    m = sorted_masks.astype(float)
    pairwise = m.T @ m
    norm = pairwise.max(axis=0)
    norm[norm == 0] = 1
    overlaps = pairwise / norm
    for i in range(overlaps.shape[0]):
        if sort_scores[i] < scores_threshold:
            continue
        if sorted_masks[:, i].sum() == 0:
            continue
        overlap_ids = set(np.nonzero(overlaps[i, :] > iou_threshold)[0])
        if not overlap_ids or i == min(overlap_ids):
            keep.add(i)
    return sorted(keep)


# from mask3d_tpu/train/postprocess.py:129 postprocess_item
def postprocess_item(
    pred_class: np.ndarray,  # [Q, C+1] logits
    pred_masks: np.ndarray,  # [N, Q] logits (padding stripped)
    coords: np.ndarray,  # [N, 3] raw coordinates (for DBSCAN)
    scene: str,
    use_dbscan: bool = True,
    dbscan_eps: float = 1.0,
    dbscan_min_points: int = 10,
    filter_out_instances: bool = True,
    scores_threshold: float = 0.8,
    iou_threshold: float = 1.0,
    topk_per_image: int = -1,
    prediction_label_ids: Optional[np.ndarray] = None,
    measure: bool = False,
) -> dict:
    """Full per-item pipeline -> evaluator-ready prediction dict.

    `prediction_label_ids` maps class indices to dataset label ids
    (reference `change_semantic_label_idxs_to_ids`,
    `semseg_structured3d.py:260-268`; default identity + 1 for `is_room`).

    `measure=True` records the reference's per-stage eval segments into
    `utils.meter`; only valid when items run sequentially.
    """
    if measure:
        mark = meter.add_timing
    else:
        def mark(_name):
            return None

    probs = softmax_excl_ignore(pred_class)
    # Reference quirk, reproduced deliberately (trainer.py:434): the
    # softmax'd probabilities with the ignore class dropped ([Q, C]) are
    # assigned back into the [Q, C+1] pred_class slot. For room detection
    # (C == 1) this BROADCASTS the room probability into both columns, so
    # get_mask_and_scores topk's over 2Q duplicated scores and emits the
    # top ceil(Q/2) queries twice each (labels 0 and 1, both remapped to
    # the room id below). For C > 1 the reference crashes on the same
    # line (torch cannot broadcast [Q, C] into [Q, C+1]); we keep the
    # sane un-duplicated path there. Pinned by
    # tests/test_postprocess_differential.py.
    if probs.shape[-1] == 1 and pred_class.shape[-1] == 2:
        probs = np.broadcast_to(probs, pred_class.shape)
    mark("eval_prep")
    masks_logits = pred_masks
    if use_dbscan:
        masks_logits = dbscan_filter_masks(
            masks_logits, coords, dbscan_eps, dbscan_min_points
        )
        mark("eval_dbscan")
    scores, masks, classes, heatmap = get_mask_and_scores(
        probs, masks_logits, topk_per_image
    )
    mark("eval_get_mask_and_scores")
    classes, masks, scores, heatmap = sort_by_score(
        scores, masks, classes, heatmap
    )
    mark("eval_sort_predictions_by_score")
    if filter_out_instances:
        kept = filter_instances(
            masks, scores, scores_threshold, iou_threshold
        )
        classes = classes[kept]
        masks = masks[:, kept]
        scores = scores[kept]
        mark("eval_filter_out_instances")
    # Reference remap semantics (`change_semantic_label_idxs_to_ids`,
    # semseg_structured3d.py:260-268): label INDEX i is rewritten to the
    # i-th dataset label id; values beyond the id list stay unchanged
    # (the duplicated label 1 from the broadcast quirk above happens to
    # already equal the is_room id).
    ids = (1,) if prediction_label_ids is None else tuple(
        np.asarray(prediction_label_ids).tolist()
    )
    label_ids = classes.copy()
    for idx, lid in enumerate(ids):
        label_ids[classes == idx] = lid
    return {
        "pred_classes": label_ids.astype(np.int32),
        "pred_masks": masks.astype(np.float32),
        "pred_scores": scores.astype(np.float32),
        "scene": scene,
    }
