"""ScanNet-style instance-segmentation evaluator + room-detection metrics.

A copy of the JAX package's numpy evaluator (mask3d_tpu/evalm/evaluator.py).

Faithful re-statement of `mask3d/benchmark/evaluate_semantic_instance.py`
(itself derived from the public ScanNet benchmark script): greedy IoU
matching per threshold with confidence-ordered precision/recall integration,
extended with the paper's custom metrics — precision/recall/F1 @ IoU 0.5,
mean matched IoU, and SDR (successfully-detected-rooms @ IoU 0.75, an
"absolute recall" starting at -num_gt and +1 per detection,
`evaluate_semantic_instance.py:437-440,511-512`).

This is the acceptance oracle of the framework, so the algorithm follows the
reference step by step (host-side numpy).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy import stats

from mask3d_tpu_torch.evalm.pointwise import (
    pointwise_from_maskwise_gt,
    pointwise_from_maskwise_preds,
)

IOU_PR = 0.5  # precision/recall matching threshold (ref :420)
IOU_SDR = 0.75  # successfully-detected-rooms threshold (ref :421)


# from mask3d_tpu/evalm/evaluator.py:31 Mask3DEvaluator
class Mask3DEvaluator:
    """Batch-incremental evaluator.

    `class_ids`/`class_names` default to the single `is_room` setup
    (reference `semseg_structured3d.py:42` DATASET_CLASSES = {1: "is_room"}).
    """

    def __init__(
        self,
        class_ids: Sequence[int] = (1,),
        class_names: Sequence[str] = ("is_room",),
        debug_best_worst_scenes: bool = False,
        debug_mean_average_precision: bool = False,
        min_region_size: int = 1,
    ):
        self.class_ids = np.asarray(class_ids)
        self.class_names = list(class_names)
        self.id_to_name = dict(zip(class_ids, class_names))
        # thresholds 0.5..0.9 step 0.05, then 0.25 appended (ref :33)
        self.iou_thresholds = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
        self.min_region_size = min_region_size
        self.debug_best_worst_scenes = debug_best_worst_scenes
        self.debug_mean_average_precision = debug_mean_average_precision
        self.scene_metrics: Dict[str, dict] = {}
        self.map_components: Dict[str, list] = {}

    def notify_new_epoch(self):
        self.scene_metrics = {}
        self.map_components = {}

    # ------------------------------------------------------------------ #
    # per-scene gt<->pred association (ref assign_instances_for_scan @304)
    # ------------------------------------------------------------------ #

    def _associate(self, pred: dict, gt_labels, points_class_gt,
                   points_instance_id_gt):
        gt2pred = {name: [] for name in self.class_names}
        pred2gt = {name: [] for name in self.class_names}

        # gt instance records per class (ref util_3d.get_instances_per_classes)
        for iid in np.unique(points_instance_id_gt):
            if iid == 0:
                continue
            label_id = int(gt_labels[iid - 1])
            if label_id not in self.id_to_name:
                continue
            vert_count = int((points_instance_id_gt == iid).sum())
            gt2pred[self.id_to_name[label_id]].append(
                {
                    "instance_id": int(iid),
                    "label_id": label_id,
                    "vert_count": vert_count,
                    "matched_pred": [],
                }
            )

        gt_ignore = ~np.isin(points_class_gt, self.class_ids)

        n_masks = pred["pred_masks"].shape[1]
        for k in range(n_masks):
            label_id = int(pred["pred_classes"][k])
            if label_id not in self.id_to_name:
                continue
            name = self.id_to_name[label_id]
            mask = pred["pred_masks"][:, k].astype(bool)
            vert_count = int(mask.sum())
            if vert_count < self.min_region_size:
                continue  # skip empty / too-small predictions (ref :341)
            rec = {
                "uid": (id(pred), k),
                "label_id": label_id,
                "vert_count": vert_count,
                "confidence": float(pred["pred_scores"][k]),
                "void_intersection": int((gt_ignore & mask).sum()),
                "matched_gt": [],
            }
            for gt_rec in gt2pred[name]:
                gt_mask = points_instance_id_gt == gt_rec["instance_id"]
                inter = int((gt_mask & mask).sum())
                if inter > 0:
                    g = dict(gt_rec, intersection=inter)
                    g.pop("matched_pred", None)
                    p = dict(rec, intersection=inter)
                    p.pop("matched_gt", None)
                    rec["matched_gt"].append(g)
                    gt_rec["matched_pred"].append(p)
            pred2gt[name].append(rec)
        return gt2pred, pred2gt

    # ------------------------------------------------------------------ #
    # AP over thresholds (ref get_matches_ap_scores @52-238)
    # ------------------------------------------------------------------ #

    def _ap_scores(self, items_matches):
        n_cls = len(self.class_names)
        n_thr = len(self.iou_thresholds)
        ap = np.zeros((n_cls, n_thr))

        for ti, thr in enumerate(self.iou_thresholds):
            pred_visited = {}
            for m in items_matches.values():
                for recs in m["pred"].values():
                    for r in recs:
                        pred_visited[r["uid"]] = False

            for ci, name in enumerate(self.class_names):
                y_true, y_score = [], []
                hard_fn = 0
                has_gt = has_pred = False

                for m in items_matches.values():
                    gts = m["gt"][name]
                    preds = m["pred"][name]
                    gts = [
                        g for g in gts
                        if g["vert_count"] >= self.min_region_size
                    ]
                    has_gt |= bool(gts)
                    has_pred |= bool(preds)

                    cur_true = np.ones(len(gts))
                    cur_score = np.full(len(gts), -np.inf)
                    cur_match = np.zeros(len(gts), dtype=bool)

                    for gi, g in enumerate(gts):
                        found = False
                        for p in g["matched_pred"]:
                            if pred_visited[p["uid"]]:
                                continue
                            iou = p["intersection"] / (
                                g["vert_count"]
                                + p["vert_count"]
                                - p["intersection"]
                            )
                            if iou > thr:
                                conf = p["confidence"]
                                if cur_match[gi]:
                                    # duplicate detection: lower score is FP
                                    hi = max(cur_score[gi], conf)
                                    lo = min(cur_score[gi], conf)
                                    cur_score[gi] = hi
                                    cur_true = np.append(cur_true, 0)
                                    cur_score = np.append(cur_score, lo)
                                    cur_match = np.append(cur_match, True)
                                else:
                                    found = True
                                    cur_match[gi] = True
                                    cur_score[gi] = conf
                                    pred_visited[p["uid"]] = True
                        if not found:
                            hard_fn += 1

                    cur_true = cur_true[cur_match]
                    cur_score = cur_score[cur_match]

                    for p in preds:
                        if p["vert_count"] == 0:
                            continue
                        found_gt = any(
                            g["intersection"]
                            / (
                                g["vert_count"]
                                + p["vert_count"]
                                - g["intersection"]
                            )
                            > thr
                            for g in p["matched_gt"]
                        )
                        if not found_gt:
                            num_ignore = p["void_intersection"]
                            for g in p["matched_gt"]:
                                if g["vert_count"] < self.min_region_size:
                                    num_ignore += g["intersection"]
                            if num_ignore / p["vert_count"] <= thr:
                                cur_true = np.append(cur_true, 0)
                                cur_score = np.append(
                                    cur_score, p["confidence"]
                                )

                    y_true.append(cur_true)
                    y_score.append(cur_score)

                if has_gt and has_pred:
                    ap[ci, ti] = self._average_precision(
                        np.concatenate(y_true),
                        np.concatenate(y_score),
                        hard_fn,
                    )
                elif has_gt:
                    ap[ci, ti] = 0.0
                else:
                    ap[ci, ti] = np.nan
        return ap

    @staticmethod
    def _average_precision(y_true, y_score, hard_false_negatives):
        """Confidence-ordered PR integration (ref :184-229)."""
        order = np.argsort(y_score)
        y_score = y_score[order]
        y_true = y_true[order]
        cum = np.cumsum(y_true)
        thresholds, uniq_idx = np.unique(y_score, return_index=True)
        n_pr = len(uniq_idx) + 1
        n_examples = len(y_score)
        n_true = cum[-1] if len(cum) > 0 else 0
        precision = np.zeros(n_pr)
        recall = np.zeros(n_pr)
        cum = np.append(cum, 0)
        for out_i, idx in enumerate(uniq_idx):
            c = cum[idx - 1]
            tp = n_true - c
            fp = n_examples - idx - tp
            fn = c + hard_false_negatives
            precision[out_i] = tp / (tp + fp)
            recall[out_i] = tp / (tp + fn)
        precision[-1] = 1.0
        recall[-1] = 0.0
        r_conv = np.concatenate([[recall[0]], recall, [0.0]])
        step_widths = np.convolve(r_conv, [-0.5, 0, 0.5], "valid")
        return float(np.dot(precision, step_widths))

    # ------------------------------------------------------------------ #
    # public entry (ref evaluate @409-590)
    # ------------------------------------------------------------------ #

    def evaluate(self, preds: List[dict], targets: List[dict],
                 log_prefix: str) -> dict:
        """preds: per item {"pred_classes" i[M], "pred_masks" [N, M],
        "pred_scores" f[M], "scene" str} in score-descending order;
        targets: per item {"labels" i[I], "masks" bool[I, N]} (unpadded).
        """
        n_cls = len(self.class_names)
        max_cid = int(self.class_ids.max()) + 1
        total_gt = np.zeros(max_cid)
        tps = np.zeros(max_cid)
        fps = np.zeros(max_cid)
        match_ious: List[float] = []
        items_matches = {}
        sdr = {}

        for item_idx, pred in enumerate(preds):
            gt_labels = np.asarray(targets[item_idx]["labels"])
            gt_masks = np.asarray(targets[item_idx]["masks"])
            num_points = pred["pred_masks"].shape[0]
            sdr[item_idx] = -int(gt_labels.shape[0])

            pts_cls_gt, pts_iid_gt = pointwise_from_maskwise_gt(
                gt_labels, gt_masks, num_points
            )
            pts_cls_pr, pts_iid_pr, pts_score_pr = (
                pointwise_from_maskwise_preds(
                    pred["pred_masks"],
                    pred["pred_classes"],
                    pred["pred_scores"],
                    num_points,
                )
            )

            # group points into instances by (pointwise) id; class by mode
            def group(iids, classes):
                out = [[] for _ in range(max_cid)]
                for iid in np.unique(iids):
                    if iid == 0:
                        continue
                    m = iids == iid
                    c = int(stats.mode(classes[m])[0])
                    if c < max_cid:
                        out[c].append(m)
                return out

            pred_groups = group(pts_iid_pr, pts_cls_pr)
            gt_groups = group(pts_iid_gt, pts_cls_gt)

            for cid in self.class_ids:
                total_gt[cid] += len(gt_groups[cid])
                for pm in pred_groups[cid]:
                    best = -1.0
                    for gm in gt_groups[cid]:
                        iou = (pm & gm).sum() / (pm | gm).sum()
                        best = max(best, iou)
                    if best > IOU_PR:
                        tps[cid] += 1
                        match_ious.append(best)
                    else:
                        fps[cid] += 1
                    if best > IOU_SDR:
                        sdr[item_idx] += 1

            gt2pred, pred2gt = self._associate(
                pred, gt_labels, pts_cls_gt, pts_iid_gt
            )
            items_matches[item_idx] = {"gt": gt2pred, "pred": pred2gt}

        ap = self._ap_scores(items_matches)
        not25 = ~np.isclose(self.iou_thresholds, 0.25)
        is50 = np.isclose(self.iou_thresholds, 0.5)
        is25 = np.isclose(self.iou_thresholds, 0.25)

        def nanmean(x):
            return float(np.nanmean(x)) if x.size and not np.isnan(x).all() \
                else float("nan")

        metrics = {
            f"{log_prefix}_mean_ap": nanmean(ap[:, not25]),
            f"{log_prefix}_mean_ap_50": nanmean(ap[:, is50]),
            f"{log_prefix}_mean_ap_25": nanmean(ap[:, is25]),
            f"{log_prefix}_classes": {
                name: {
                    "ap": float(np.average(ap[ci, not25])),
                    "ap_50": float(np.average(ap[ci, is50])),
                    "ap_25": float(np.average(ap[ci, is25])),
                }
                for ci, name in enumerate(self.class_names)
            },
        }

        if self.debug_mean_average_precision:
            for ti, thr in enumerate(self.iou_thresholds):
                key = f"{thr:.2f}"
                self.map_components.setdefault(key, []).append(
                    nanmean(ap[:, ti])
                )

        prec = np.zeros(n_cls)
        rec = np.zeros(n_cls)
        for ci, cid in enumerate(self.class_ids):
            tp, fp = tps[cid], fps[cid]
            rec[ci] = tp / total_gt[cid] if total_gt[cid] > 0 else 1.0
            prec[ci] = tp / (tp + fp) if tp + fp > 0 else 0.0
        mp, mr = float(prec.mean()), float(rec.mean())
        f1 = 2 * mp * mr / (mp + mr) if mp + mr > 0 else 0.0
        miou = float(np.mean(match_ious)) if match_ious else 0.0
        sdr_mean = float(np.mean(list(sdr.values())))

        metrics[f"{log_prefix}_mean_precision_50"] = mp
        metrics[f"{log_prefix}_mean_recall_50"] = mr
        metrics[f"{log_prefix}_mean_f1_50"] = f1
        metrics[f"{log_prefix}_mean_match_IoU"] = miou
        metrics[f"{log_prefix}_successfully_detected_rooms"] = sdr_mean

        if self.debug_best_worst_scenes:
            assert len(preds) == 1, (
                "best/worst scene tracking needs batch size 1 "
                "(reference evaluate_semantic_instance.py:577)"
            )
            self.scene_metrics[preds[0]["scene"]] = {
                "mean_ap": metrics[f"{log_prefix}_mean_ap"],
                "mean_ap_25": metrics[f"{log_prefix}_mean_ap_25"],
                "mean_ap_50": metrics[f"{log_prefix}_mean_ap_50"],
                "mean_precision_50": mp,
                "mean_recall_50": mr,
                "mean_f1_50": f1,
                "mean_match_IoU": miou,
                "successfully_detected_rooms": sdr_mean,
            }
        return metrics

    def get_highest_lowest_metric_scenes(self, decision_metric: str,
                                         num_scenes: int):
        ordered = sorted(
            self.scene_metrics.items(), key=lambda kv: kv[1][decision_metric]
        )
        return ordered[-num_scenes:], ordered[:num_scenes]

    def get_mean_average_precision_components(self):
        return {
            k: float(np.nanmean(v)) for k, v in self.map_components.items()
        }
