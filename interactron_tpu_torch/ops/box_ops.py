"""Bounding-box ops on torch tensors (counterpart of
interactron_tpu/ops/box_ops.py): no asserts on degenerate boxes, everything
broadcasts over leading batch dims."""

import torch


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b):
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1)


def box_area(b):
    """Area of xyxy boxes, (..., 4) -> (...)."""
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(boxes1, boxes2, eps=0.0):
    """Pairwise IoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> iou, union (..., N, M)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / (union + eps), union


def generalized_box_iou(boxes1, boxes2, eps=0.0):
    """Pairwise GIoU of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M);
    `eps` keeps padded all-zero boxes finite."""
    iou, union = box_iou(boxes1, boxes2, eps=eps)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / (area + eps)
