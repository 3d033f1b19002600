"""The reference task with Deformable DETR as its detector
(`MODEL.BACKBONE: resnet50_deformable`): reference/task.py's ReferenceTask,
whose served calls, inner gradient, step and train step it keeps, with the
detector of reference/deformable_detr.py."""

import torch
from torch import nn

from portbench.reference import deformable_detr
from portbench.reference.fusion import build_fusion
from portbench.reference.task import ReferenceTask


class DeformableReferenceTask(ReferenceTask):
    def __init__(self, config, device):
        nn.Module.__init__(self)
        self.device = torch.device(device)
        m = config.MODEL
        self.detector = deformable_detr.build(m)
        self.fusion = build_fusion(config)
        self.num_classes = m.NUM_CLASSES
        self.costs = dict(cost_class=float(m.get("SET_COST_CLASS", 1.0)),
                          cost_bbox=float(m.get("SET_COST_BBOX", 5.0)),
                          cost_giou=float(m.get("SET_COST_GIOU", 2.0)))
        self.adaptive_lr = float(m.get("ADAPTIVE_LR", 1e-3))
        self.inner_batch = int(config.TRAINER.get("INNER_BATCH", 1))
        self.with_policy = m.TYPE == "interactron"
        inner = m.get("INNER_DTYPE") or m.get("DTYPE")
        self.fast_dtype = torch.bfloat16 if inner == "bfloat16" else None
        self.kept_g = None
        self.requires_grad_(False)
        self.eval()
        self.to(self.device)


def reference_task(config, device):
    """The reference task of `config` (a reference Config): the deformable
    one for its backbones, reference/task.py's otherwise."""
    if config.MODEL.get("BACKBONE") in deformable_detr.BACKBONES:
        return DeformableReferenceTask(config, device)
    return ReferenceTask(config, device)


