"""Evaluation scoring and average precision (own copy of
interactron_tpu/engine/ap.py).

The detection records and the 101-recall-point interpolated AP keep the
reference's quirks: pooled categories, destructive-threshold filtering, fn
records never filtered by confidence, and the `r[0]+1e-6` prepend. Box
conversion and NMS are the port's torch ops; the matching and AP are numpy
on the host (tiny arrays).
"""

import numpy as np
import torch

from interactron_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy
from interactron_tpu_torch.ops.nms import nms_indices
from interactron_tpu_torch.utils import constants as C


def match_predictions_to_detections(ious):
    """Greedy stable-marriage-flavored matcher.

    ious: (P, G) numpy array. Returns (best_ious (G,), best_idxs (G,))."""
    ious = np.asarray(ious)
    P, G = ious.shape
    p_preferences = np.argsort(-ious, axis=1, kind="stable")
    p_preference_idxs = np.zeros(P, np.int64)
    free_ps = np.ones(P, bool)
    tentative = -np.ones(G, np.int64)
    for _ in range(G):
        proposals = p_preferences[np.arange(P), np.clip(p_preference_idxs, 0, G - 1)]
        for j in range(G):
            new_match = int(np.argmax(ious[:, j] * (proposals == j)))
            if tentative[j] != -1 and tentative[j] != new_match:
                free_ps[tentative[j]] = True
            tentative[j] = new_match
            free_ps[new_match] = False
        p_preference_idxs[free_ps] += 1
        if np.count_nonzero(~free_ps) >= min(P, G):
            break
    best_idxs = tentative
    best_ious = np.zeros(G, np.float64)
    sel = best_idxs != -1
    best_ious[sel] = ious[best_idxs[sel], sel]
    best_idxs[best_ious == 0.0] = -1
    return best_ious, best_idxs


def _iou_matrix(a, b):
    """(P,4) x (G,4) xyxy -> (P,G)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter)


def _host(x):
    """A numpy array of `x` (numpy or torch; half-precision floats as fp32)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype in (torch.bfloat16, torch.float16) else x).numpy()
    return np.asarray(x)


def _xyxy(boxes_cxcywh):
    return box_cxcywh_to_xyxy(torch.as_tensor(_host(boxes_cxcywh))).numpy()


def score_frame(pred_logits, pred_boxes, gt_boxes_cxcywh, gt_cats, image_path,
                num_classes=C.NUM_CLASSES, nms_iou=0.5):
    """Score one frame's predictions against its ground truth: the
    reference's detection records.

    pred_logits (Q, num_classes+1), pred_boxes (Q, 4) cxcywh,
    gt_boxes_cxcywh (G, 4), gt_cats (G,): numpy arrays or torch tensors."""
    logits = _host(pred_logits).astype(np.float32)
    pb = _xyxy(pred_boxes)
    gt_boxes = _xyxy(gt_boxes_cxcywh)
    gt_cats = _host(gt_cats)

    e = np.exp(logits - logits.max(-1, keepdims=True))
    prob = e / e.sum(-1, keepdims=True)
    pred_cats = prob.argmax(-1)
    pred_scores = prob.max(-1)

    keep = pred_cats != num_classes
    pb, pred_cats, pred_scores = pb[keep], pred_cats[keep], pred_scores[keep]
    if len(pb):
        order = nms_indices(torch.as_tensor(pb), torch.as_tensor(pred_scores), nms_iou).numpy()
        pb, pred_cats, pred_scores = pb[order], pred_cats[order], pred_scores[order]

    detections = []
    pred_cat_set = set(int(c) for c in pred_cats)
    gt_cat_set = set(int(c) for c in gt_cats)
    pred_only = set(C.THOR_CLASS_IDS).intersection(pred_cat_set - gt_cat_set)

    def _area(b):
        return float((b[2] - b[0]) * (b[3] - b[1]))

    def rec(iou, match, typ, cat, score, box):
        return {
            "iou": float(iou), "category_match": match, "type": typ,
            "pred_cat": int(cat), "pred_score": float(score),
            "box": [float(c) for c in box], "area": _area(box), "img": image_path,
        }

    for cat in gt_cat_set:
        cat_gt = gt_boxes[gt_cats == cat]
        if np.any(pred_cats == cat):
            cp = pb[pred_cats == cat]
            cs = pred_scores[pred_cats == cat]
            ious = _iou_matrix(cp, cat_gt)
            best_ious, best_idx = match_predictions_to_detections(ious)
            for i in range(ious.shape[0]):
                typ = "tp" if np.any(best_idx == i) else "fp"
                detections.append(rec(ious[i].max(), True, typ, cat, cs[i], cp[i]))
            for j in range(ious.shape[1]):
                if best_ious[j] == 0.0:
                    detections.append(rec(0.0, False, "fn", cat, 0.0, cat_gt[j]))
        else:
            for j in range(cat_gt.shape[0]):
                detections.append(rec(0.0, False, "fn", cat, 0.0, cat_gt[j]))
    for cat in pred_only:
        cp = pb[pred_cats == cat]
        cs = pred_scores[pred_cats == cat]
        for i in range(len(cp)):
            detections.append(rec(0.0, False, "fp", cat, cs[i], cp[i]))
    return detections


def compute_ap(detections, nsamples=100, iou_thresholds=(0.5,), min_area=0.0, max_area=1.0):
    """101-recall-point interpolated AP over pooled categories."""
    dets = [d for d in detections if min_area < d["area"] < max_area]
    aps = []
    for iou_thresh in iou_thresholds:
        tps = [d for d in dets if d["type"] == "tp" and d["iou"] >= iou_thresh]
        fps = [d for d in dets if d["type"] == "fp"] + [
            d for d in dets if d["type"] == "tp" and d["iou"] < iou_thresh
        ]
        n_fn = len([d for d in dets if d["type"] == "fn"])
        tp_scores = np.sort(np.asarray([d["pred_score"] for d in tps]))[::-1]
        fp_scores = np.sort(np.asarray([d["pred_score"] for d in fps]))[::-1]
        p, r = [], []
        for conf in np.arange(0.0, 1.0, 1.0 / nsamples):
            ntp = int(np.sum(tp_scores >= conf))
            nfp = int(np.sum(fp_scores >= conf))
            p.append(0 if ntp == 0 else ntp / (ntp + nfp))
            r.append(0 if ntp == 0 else ntp / (ntp + n_fn))
        p = [0.0] + p
        r = [r[0] + 0.000001] + r
        samples = []
        r_idx = 0
        for r_cutoff in np.arange(1.0, -0.0001, -0.01):
            while r_idx < len(r) - 1 and r[r_idx] > r_cutoff:
                r_idx += 1
            samples.append(max(p[: r_idx + 1]))
        aps.append(np.mean(samples))
    return float(np.mean(aps))


def compute_cat_ap(detections, nsamples=100, iou_thresholds=(0.5,), min_area=0.0,
                   max_area=1.0, min_gt=5, verbose=False):
    """Per-category AP, averaged over categories with >= min_gt ground
    truths (the standard per-category AP, not the reference's running mean
    inside the recall-cutoff loop). The live pipeline does not use it."""
    aps = []
    cats = sorted(set(d["pred_cat"] for d in detections))
    for cat in cats:
        cd = [d for d in detections if d["pred_cat"] == cat and min_area < d["area"] < max_area]
        if len([d for d in cd if d["type"] in ("tp", "fn")]) < min_gt:
            continue
        ap = compute_ap(cd, nsamples=nsamples, iou_thresholds=iou_thresholds)
        aps.append(ap)
        if verbose:
            print("{}: {:06f}".format(cat, ap))
    return float(np.mean(aps)) if aps else 0.0


def ap_summary(detections):
    """The reference's full AP breakdown."""
    rng5095 = list(np.arange(0.5, 1.0, 0.05))
    small = 32**2 / 300**2
    med = 96**2 / 300**2
    return {
        "AP_50": compute_ap(detections, iou_thresholds=[0.5]),
        "AP_75": compute_ap(detections, iou_thresholds=[0.75]),
        "AP": compute_ap(detections, iou_thresholds=rng5095),
        "AP_small": compute_ap(detections, iou_thresholds=rng5095, min_area=0.0, max_area=small),
        "AP_medium": compute_ap(detections, iou_thresholds=rng5095, min_area=small, max_area=med),
        "AP_large": compute_ap(detections, iou_thresholds=rng5095, min_area=med, max_area=1.0),
    }
