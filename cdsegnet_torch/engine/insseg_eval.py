"""Instance-segmentation evaluation: ScanNet-benchmark mAP@[.5:.95], AP50
and AP25.

A numpy copy of `cdsegnet_tpu/engine/insseg_eval.py` (the port imports
nothing of the JAX package), itself the standard ScanNet instance-seg
protocol (reference `pointcept/engines/hooks/evaluator.py:213-589`):
per-class greedy matching of predicted masks to ground-truth instances at
IoU thresholds [0.5:0.95:0.05] and 0.25, all-point average precision per
(class, threshold), averaged into mAP / AP50 / AP25. `InsSegEvaluator`
(`engine/hooks.py`) runs it on the host after each evaluated epoch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)


def associate_instances(
    pred_masks: np.ndarray,  # (P, N) bool
    pred_classes: np.ndarray,  # (P,) int
    pred_scores: np.ndarray,  # (P,) float
    segment: np.ndarray,  # (N,) int ground-truth semantics
    instance: np.ndarray,  # (N,) int ground-truth instance ids, -1 = none
    num_classes: int,
    segment_ignore_index: Sequence[int] = (-1,),
    min_region_size: int = 100,
) -> Dict:
    """Build one scene's per-class gt/pred association record."""
    void_mask = np.isin(segment, segment_ignore_index)
    valid_classes = [
        c for c in range(num_classes) if c not in segment_ignore_index
    ]
    gt: Dict[int, List[Dict]] = {c: [] for c in valid_classes}
    pred: Dict[int, List[Dict]] = {c: [] for c in valid_classes}

    inst_ids, first, counts = np.unique(
        instance, return_index=True, return_counts=True
    )
    inst_class = segment[first]
    gt_index_of = {}
    for i, inst_id in enumerate(inst_ids):
        if inst_id < 0 or inst_class[i] not in gt:
            continue
        gt_index_of[int(inst_id)] = (int(inst_class[i]), len(gt[inst_class[i]]))
        gt[inst_class[i]].append(
            dict(
                instance_id=int(inst_id),
                vert_count=int(counts[i]),
                matched=[],  # (pred_record, intersection)
            )
        )

    for p in range(pred_masks.shape[0]):
        cls = int(pred_classes[p])
        if cls not in pred:
            continue
        mask = pred_masks[p].astype(bool)
        vert_count = int(mask.sum())
        if vert_count < min_region_size:
            continue
        rec = dict(
            confidence=float(pred_scores[p]),
            vert_count=vert_count,
            void_intersection=int(np.count_nonzero(void_mask & mask)),
            matched=[],  # (gt_record, intersection)
        )
        # intersections with ground-truth instances of the same class
        ids, cnt = np.unique(instance[mask], return_counts=True)
        for inst_id, inter in zip(ids, cnt):
            key = gt_index_of.get(int(inst_id))
            if key is None or key[0] != cls:
                continue
            g = gt[cls][key[1]]
            rec["matched"].append((g, int(inter)))
            g["matched"].append((rec, int(inter)))
        pred[cls].append(rec)
    return dict(gt=gt, pred=pred)


def _average_precision(y_true, y_score, hard_fn):
    """All-point AP over the accumulated (tp/fp, score) pairs plus hard
    false negatives — the ScanNet-benchmark precision/recall integration."""
    order = np.argsort(y_score)
    y_score = y_score[order]
    y_true = y_true[order]
    cum_true = np.cumsum(y_true)
    num_true = cum_true[-1] if len(cum_true) else 0
    thresholds, idx_first = np.unique(y_score, return_index=True)
    n_pr = len(idx_first) + 1
    precision = np.zeros(n_pr)
    recall = np.zeros(n_pr)
    cum_true = np.append(cum_true, 0)
    n = len(y_score)
    for r, i in enumerate(idx_first):
        below = cum_true[i - 1] if i > 0 else 0
        tp = num_true - below
        fp = n - i - tp
        fn = below + hard_fn
        precision[r] = tp / max(tp + fp, 1e-10)
        recall[r] = tp / max(tp + fn, 1e-10)
    precision[-1], recall[-1] = 1.0, 0.0
    r_ext = np.concatenate([[recall[0]], recall, [0.0]])
    step = np.convolve(r_ext, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step))


def evaluate_matches(
    scenes: List[Dict],
    valid_classes: Sequence[int],
    overlaps: np.ndarray = OVERLAPS,
    min_region_size: int = 100,
) -> np.ndarray:
    """AP per (class, overlap threshold) over per-scene association records."""
    ap = np.full((len(valid_classes), len(overlaps)), np.nan)
    for oi, th in enumerate(overlaps):
        for li, cls in enumerate(valid_classes):
            y_true, y_score = [], []
            hard_fn = 0
            has_gt = has_pred = False
            visited = set()  # greedy: one gt per pred per threshold
            for scene in scenes:
                gts = [
                    g for g in scene["gt"].get(cls, [])
                    if g["vert_count"] >= min_region_size
                ]
                preds = scene["pred"].get(cls, [])
                has_gt |= bool(gts)
                has_pred |= bool(preds)
                cur_true, cur_score = [], []
                for g in gts:
                    found = False
                    best = sorted(
                        g["matched"], key=lambda m: -m[0]["confidence"]
                    )
                    for p, inter in best:
                        if id(p) in visited:
                            continue
                        iou = inter / (g["vert_count"] + p["vert_count"] - inter)
                        if iou > th:
                            if found:
                                # duplicate detection: lower score is a FP
                                cur_true.append(0.0)
                                cur_score.append(p["confidence"])
                            else:
                                found = True
                                cur_true.append(1.0)
                                cur_score.append(p["confidence"])
                                visited.add(id(p))
                    if not found:
                        hard_fn += 1
                for p in preds:
                    matched_any = any(
                        inter / (g["vert_count"] + p["vert_count"] - inter) > th
                        for g, inter in p["matched"]
                    )
                    if matched_any:
                        continue
                    # ignore predictions mostly covering void / tiny gts
                    num_ignore = p["void_intersection"]
                    for g, inter in p["matched"]:
                        if g["vert_count"] < min_region_size:
                            num_ignore += inter
                    if num_ignore / p["vert_count"] <= th:
                        cur_true.append(0.0)
                        cur_score.append(p["confidence"])
                y_true += cur_true
                y_score += cur_score
            if has_gt and has_pred:
                ap[li, oi] = _average_precision(
                    np.asarray(y_true), np.asarray(y_score), hard_fn
                )
            elif has_gt:
                ap[li, oi] = 0.0
    return ap


def _nanmean(x: np.ndarray, axis=None):
    """nanmean that returns NaN for all-NaN slices without emitting
    RuntimeWarnings (classes absent from both GT and predictions)."""
    count = np.sum(~np.isnan(x), axis=axis)
    total = np.nansum(x, axis=axis)
    return np.where(count > 0, total / np.maximum(count, 1), np.nan)


def summarize_ap(ap: np.ndarray, overlaps: np.ndarray = OVERLAPS) -> Dict:
    o50 = np.isclose(overlaps, 0.5)
    o25 = np.isclose(overlaps, 0.25)
    main = ~o25
    return dict(
        all_ap=float(_nanmean(ap[:, main])),
        all_ap_50=float(_nanmean(ap[:, o50])),
        all_ap_25=float(_nanmean(ap[:, o25])),
        per_class_ap=_nanmean(ap[:, main], axis=1),
    )


def proposals_from_clusters(
    cluster_ids: np.ndarray,  # (N,) int, cluster id per point (N = invalid)
    sem_pred: np.ndarray,  # (N,) int predicted class per point
    sem_probs: np.ndarray,  # (N, K) softmax probabilities
    valid: np.ndarray,  # (N,) bool
    min_points: int = 100,
):
    """Turn per-point cluster ids into (masks, classes, scores) proposals.

    Score = mean predicted probability of the proposal's class over its
    points (the reference's v1m1 PointGroup has no score network; its
    confidence comes from the semantic head).
    """
    n = cluster_ids.shape[0]
    masks, classes, scores = [], [], []
    ids = np.unique(cluster_ids[valid & (cluster_ids < n)])
    for cid in ids:
        m = (cluster_ids == cid) & valid
        cnt = int(m.sum())
        if cnt < min_points:
            continue
        cls = int(np.bincount(sem_pred[m]).argmax())
        masks.append(m)
        classes.append(cls)
        scores.append(float(sem_probs[m, cls].mean()))
    if not masks:
        return (
            np.zeros((0, n), bool), np.zeros((0,), np.int64),
            np.zeros((0,), np.float32),
        )
    return (
        np.stack(masks), np.asarray(classes, np.int64),
        np.asarray(scores, np.float32),
    )
