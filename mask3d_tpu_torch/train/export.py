"""Prediction export: .las with gt+pred dims, generic text export, confusion CSV.

A copy of mask3d_tpu/train/export.py; the confusion matrix is computed in
numpy (scikit-learn's `confusion_matrix(normalize="true")`, which the port
does not depend on).

Rebuild of `mask3d/utils/utils.py:112-374` (M15) and the export paths of the
eval step (`mask3d/trainer/trainer.py:310-371,527-550`).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from mask3d_tpu_torch.data.las import write_las
from mask3d_tpu_torch.evalm.pointwise import (
    pointwise_from_maskwise_gt,
    pointwise_from_maskwise_preds,
    renumber_instance_ids,
)


# from mask3d_tpu/train/export.py:22 save_confusion_matrix_csv
def save_confusion_matrix_csv(y_true, y_pred, file_path):
    """Row-normalized confusion matrix CSV (`utils.py:115-138`)."""
    import pandas as pd

    if y_true.size == 0:
        y_true = np.zeros(len(y_pred))
    labels = np.unique(np.concatenate((y_true, y_pred)))
    counts = np.zeros((len(labels), len(labels)), np.int64)
    np.add.at(counts, (np.searchsorted(labels, y_true),
                       np.searchsorted(labels, y_pred)), 1)
    with np.errstate(all="ignore"):
        cm = np.nan_to_num(counts / counts.sum(axis=1, keepdims=True))
    pd.DataFrame(cm, index=labels, columns=labels).to_csv(file_path)


# from mask3d_tpu/train/export.py:34 export_las_prediction_and_gt
def export_las_prediction_and_gt(
    coordinates: np.ndarray,
    features: np.ndarray,
    labels_gt: np.ndarray,
    masks_gt: np.ndarray,
    pred_masks: np.ndarray,
    pred_classes: np.ndarray,
    pred_scores: np.ndarray,
    file_path: str,
):
    """`save_las_prediction_and_gt` (`utils.py:284-328`): .las with extra
    dims class / class_pred / instance / instance_pred / score_pred."""
    n = pred_masks.shape[0]
    cls_gt, iid_gt = pointwise_from_maskwise_gt(labels_gt, masks_gt, n)
    cls_pr, iid_pr, score_pr = pointwise_from_maskwise_preds(
        pred_masks, pred_classes, pred_scores, n
    )
    save_confusion_matrix_csv(
        cls_gt, cls_pr, os.path.splitext(file_path)[0] + "_confusion_matrix.csv"
    )
    iid_pr = renumber_instance_ids(iid_pr)
    intensity = np.rint(np.minimum(features[:, 0], 1) * 255).astype(np.uint16)
    write_las(
        file_path,
        coordinates.astype(np.float64),
        extra_dims={
            "class": cls_gt.astype(np.int8),
            "class_pred": cls_pr.astype(np.int8),
            "instance": iid_gt.astype(np.int16),
            "instance_pred": iid_pr.astype(np.int16),
            "score_pred": score_pr.astype(np.float32),
        },
        rgb=np.stack([intensity] * 3, axis=1),
    )


# from mask3d_tpu/train/export.py:70 export_prediction_generic
def export_prediction_generic(base_path: str, scene: str,
                              pred_masks, pred_scores, pred_classes,
                              score_threshold: float = 0.0001):
    """Original-Mask3D text export (`trainer.py:310-334`)."""
    Path(base_path, "pred_mask").mkdir(parents=True, exist_ok=True)
    with open(os.path.join(base_path, f"{scene}.txt"), "w") as fout:
        for k in range(len(pred_classes)):
            if pred_scores[k] <= score_threshold:
                continue
            mask_rel = f"pred_mask/{scene}_{k}.txt"
            np.savetxt(
                os.path.join(base_path, mask_rel),
                pred_masks[:, k].astype(np.uint8),
                fmt="%d",
            )
            fout.write(f"{mask_rel} {int(pred_classes[k])} {pred_scores[k]}\n")
