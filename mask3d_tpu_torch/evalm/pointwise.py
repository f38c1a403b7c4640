"""Mask-wise <-> point-wise label conversion.

A copy of mask3d_tpu/evalm/pointwise.py.

Rebuild of `mask3d/utils/utils.py:227-281`: predictions are written from the
lowest-score mask to the highest, so higher-score masks overwrite overlapping
lower-score ones; instance ids start at 1 (0 = background / no prediction).
"""

from __future__ import annotations

import numpy as np

NO_PRED_OR_INSTANCE = 0


# from mask3d_tpu/evalm/pointwise.py:15 pointwise_from_maskwise_preds
def pointwise_from_maskwise_preds(pred_masks, pred_classes, pred_scores,
                                  num_points):
    """pred_masks: [N, M] (column m = mask of prediction m, score-descending
    order expected); returns (class i32[N], instance_id i32[N], score f32[N]).
    """
    cls = np.full(num_points, NO_PRED_OR_INSTANCE, np.int32)
    iid = np.full(num_points, NO_PRED_OR_INSTANCE, np.int32)
    score = np.full(num_points, float(NO_PRED_OR_INSTANCE), np.float32)
    m = pred_masks.shape[1]
    next_id = NO_PRED_OR_INSTANCE + 1
    # Reverse order: highest-score mask written last wins overlaps
    # (reference utils.py:238-254).
    for k in reversed(range(m)):
        sel = pred_masks[:, k].astype(bool)
        cls[sel] = int(pred_classes[k])
        score[sel] = pred_scores[k]
        iid[sel] = next_id
        next_id += 1
    return cls, iid, score


# from mask3d_tpu/evalm/pointwise.py:36 pointwise_from_maskwise_gt
def pointwise_from_maskwise_gt(labels_gt, masks_gt, num_points):
    """masks_gt: [I, N]; returns (class i32[N], instance_id i32[N]) with
    instance_id = instance_index + 1 (reference utils.py:259-281)."""
    cls = np.full(num_points, NO_PRED_OR_INSTANCE, np.int32)
    iid = np.full(num_points, NO_PRED_OR_INSTANCE, np.int32)
    for i in range(masks_gt.shape[0]):
        sel = masks_gt[i].astype(bool)
        cls[sel] = int(labels_gt[i])
        iid[sel] = i + 1
    return cls, iid


# from mask3d_tpu/evalm/pointwise.py:48 renumber_instance_ids
def renumber_instance_ids(ids):
    """Continuous ids starting at 1 (reference utils.py:369-374)."""
    uniq = np.unique(ids)
    remap = {int(v): i + 1 for i, v in enumerate(uniq)}
    return np.vectorize(remap.get)(ids)
