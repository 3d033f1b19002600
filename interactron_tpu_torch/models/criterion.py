"""Hungarian matcher + set-prediction criterion on padded targets
(counterpart of interactron_tpu/models/criterion.py).

Targets are fixed-shape: labels (B, M) int, boxes (B, M, 4) normalised
cxcywh, valid (B, M) bool. The assignment is solved on the host
(ops/hungarian.py) from the detached cost; the losses are torch ops on the
device and differentiable in the predictions.

  * cost = cost_class * (-prob[tgt]) + cost_bbox * L1 + cost_giou * (-GIoU)
    on softmax probabilities;
  * loss_ce: weighted cross entropy over all queries, unmatched queries
    target the no-object class with weight `background_c`;
  * loss_bbox / loss_giou: sums over matched pairs / num_boxes, the valid
    target count of the call (at least 1);
  * cardinality_error / class_error for logging.
"""

import torch
import torch.nn.functional as F

from interactron_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy, generalized_box_iou
from interactron_tpu_torch.ops.hungarian import batched_solve_padded


def hungarian_match(outputs, targets, cost_class=1.0, cost_bbox=5.0, cost_giou=2.0):
    """col_to_row (B, M) int64 on the predictions' device: for each padded
    target the matched query; meaningful at valid targets only."""
    logits = outputs["pred_logits"].detach().float()
    boxes = outputs["pred_boxes"].detach().float()
    tgt_boxes = targets["boxes"].float()
    prob = logits.softmax(-1)
    idx = targets["labels"].long().clamp(min=0)[:, None, :].expand(-1, prob.shape[1], -1)
    c_class = -torch.gather(prob, 2, idx)
    c_bbox = (boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(boxes), box_cxcywh_to_xyxy(tgt_boxes),
                                  eps=1e-8)
    cost = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    if cost.shape[2] > cost.shape[1]:
        raise ValueError("more padded targets than queries")
    col_to_row = batched_solve_padded(cost.cpu().numpy(), targets["valid"].cpu().numpy())
    return torch.as_tensor(col_to_row, device=logits.device)


def _elementwise_giou(b1, b2, eps=1e-8):
    """GIoU between aligned boxes: (..., 4) x (..., 4) -> (...)."""
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / (union + eps)
    lt2 = torch.minimum(b1[..., :2], b2[..., :2])
    rb2 = torch.maximum(b1[..., 2:], b2[..., 2:])
    wh2 = (rb2 - lt2).clamp(min=0.0)
    area = wh2[..., 0] * wh2[..., 1]
    return iou - (area - union) / (area + eps)


def set_criterion(outputs, targets, *, num_classes, background_c=0.1, cost_class=1.0,
                  cost_bbox=5.0, cost_giou=2.0, per_frame=False):
    """Losses of the frames stacked along B: a dict of fp32 scalars loss_ce,
    loss_bbox, loss_giou, cardinality_error, class_error, plus with
    `per_frame` a "_per_frame" dict of (B,) pieces from which frame f's own
    losses follow with the same assignment."""
    logits = outputs["pred_logits"].float()
    pboxes = outputs["pred_boxes"].float()
    labels = targets["labels"].long()
    tgt_boxes = targets["boxes"].float()
    valid = targets["valid"].bool()
    b, q, _ = logits.shape
    col_to_row = hungarian_match(outputs, targets, cost_class, cost_bbox, cost_giou)
    vf = valid.float()
    num_boxes = vf.sum().clamp(min=1.0)

    # loss_ce: matched queries take their target's label, the rest no-object
    target_classes = torch.full((b, q), num_classes, dtype=torch.long, device=logits.device)
    fr, tg = valid.nonzero(as_tuple=True)
    target_classes[fr, col_to_row[fr, tg]] = labels[fr, tg]
    nll = -torch.gather(F.log_softmax(logits, -1), 2, target_classes[..., None])[..., 0]
    w = torch.where(target_classes == num_classes, background_c, 1.0)
    loss_ce = (w * nll).sum() / w.sum()

    # box losses over matched pairs
    rows = col_to_row.clamp(0, q - 1)
    src_boxes = torch.gather(pboxes, 1, rows[..., None].expand(-1, -1, 4))
    l1 = (src_boxes - tgt_boxes).abs().sum(-1)
    loss_bbox = (l1 * vf).sum() / num_boxes
    giou_el = _elementwise_giou(box_cxcywh_to_xyxy(src_boxes), box_cxcywh_to_xyxy(tgt_boxes))
    loss_giou = ((1.0 - giou_el) * vf).sum() / num_boxes

    # logging metrics
    with torch.no_grad():
        card_pred = (logits.argmax(-1) != num_classes).sum(1).float()
        cardinality_error = (card_pred - vf.sum(1)).abs().mean()
        matched = torch.gather(logits, 1, rows[..., None].expand(-1, -1, logits.shape[-1]))
        correct = (matched.argmax(-1) == labels) & valid
        class_error = 100.0 * (1.0 - correct.float().sum() / vf.sum().clamp(min=1.0))

    out = {"loss_ce": loss_ce, "loss_bbox": loss_bbox, "loss_giou": loss_giou,
           "cardinality_error": cardinality_error, "class_error": class_error}
    if per_frame:
        out["_per_frame"] = {
            "ce_num": (w * nll).sum(1),
            "ce_den": w.sum(1),
            "bbox_sum": (l1 * vf).sum(1),
            "giou_sum": ((1.0 - giou_el) * vf).sum(1),
            "num_boxes": vf.sum(1),
        }
    return out
