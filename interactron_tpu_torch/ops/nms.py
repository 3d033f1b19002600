"""Non-maximum suppression for fixed-size (padded) box sets in torch (own
copy of interactron_tpu/ops/nms.py; torchvision is not a dependency).

N is small (<= 50 queries), so an exact O(N^2) sweep is both faithful and
fast: one pairwise IoU matrix, then greedy suppression in score order.
"""

import torch

from interactron_tpu_torch.ops.box_ops import box_iou


def nms_mask(boxes, scores, iou_threshold, valid=None):
    """Exact greedy NMS.

    boxes (N, 4) xyxy and scores (N,) tensors; a box whose IoU with a kept
    higher-scoring box is > `iou_threshold` (strict, as torchvision) is
    suppressed; `valid` (N,) bool marks entries that may be kept (invalid
    ones never are). Scores are ranked by a stable descending sort, so
    equal scores keep their index order. Returns keep (N,) bool in the
    original index order."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    eff_scores = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.argsort(-eff_scores, stable=True)
    iou, _ = box_iou(boxes[order], boxes[order])
    keep_s = valid[order].clone()
    later = torch.arange(n, device=boxes.device)
    for i in range(n):
        keep_s &= ~((iou[i] > iou_threshold) & (later > i) & keep_s[i])
    keep = torch.zeros_like(keep_s)
    keep[order] = keep_s
    return keep


def nms_indices(boxes, scores, iou_threshold, valid=None):
    """Kept indices sorted by decreasing score, equal scores in index order
    (torchvision's return convention), as an int64 tensor."""
    idx = torch.nonzero(nms_mask(boxes, scores, iou_threshold, valid=valid)).flatten()
    return idx[torch.argsort(-scores[idx], stable=True)]
