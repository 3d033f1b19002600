"""Task-model base (counterpart of interactron_tpu/tasks/base.py): builds the
detector and fusion modules from a config and exposes the module functions
the tasks call.

The model lives on `device`, which is CUDA unless the caller asks for the
CPU; without CUDA a CUDA model raises instead of running on the CPU.
Parameters are fp32 and never require grad: predict's inner step and the
train step differentiate explicit leaf copies of them, passed in through
`functional_call` (tasks/interactron.py), and the trainer writes the
gradients back (engine/trainer.py).
"""

import torch
from torch import nn
from torch.func import functional_call

from interactron_tpu_torch.models.criterion import set_criterion
from interactron_tpu_torch.models.detr import DETR
from interactron_tpu_torch.models.fusion import build_fusion
from interactron_tpu_torch.utils import constants as C

_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None):
    """`device` as a torch.device: CUDA by default, and an error when CUDA is
    asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


class TaskModel(nn.Module):
    needs_fusion = False

    def __init__(self, config, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        m = config.MODEL
        self.dtype = _DTYPES[m.get("DTYPE")]
        self.detector = DETR(
            num_classes=m.NUM_CLASSES,
            num_queries=int(m.get("NUM_QUERIES", C.NUM_QUERIES)),
            d_model=int(m.get("D_MODEL", 256)),
            num_heads=int(m.get("DETR_NUM_HEADS", 8)),
            num_encoder_layers=int(m.get("NUM_ENCODER_LAYERS", 6)),
            num_decoder_layers=int(m.get("NUM_DECODER_LAYERS", 6)),
            ff_dim=int(m.get("DETR_FF_DIM", 2048)),
            dropout_rate=float(m.get("DETR_DROPOUT", 0.1)),
            backbone=m.get("BACKBONE", "resnet50"),
            dtype=self.dtype,
        )
        self.fusion = build_fusion(config, self.dtype) if self.needs_fusion else None
        self.num_classes = m.NUM_CLASSES
        self.cost_class = float(m.get("SET_COST_CLASS", 1.0))
        self.cost_bbox = float(m.get("SET_COST_BBOX", 5.0))
        self.cost_giou = float(m.get("SET_COST_GIOU", 2.0))
        self.adaptive_lr = float(m.get("ADAPTIVE_LR", 1e-3))
        inner = m.get("INNER_DTYPE")
        # the inner step runs in the compute dtype unless that is fp32
        self.inner_dtype = (_DTYPES[inner] if inner is not None
                            else (self.dtype if self.dtype != torch.float32 else None))
        self.requires_grad_(False)
        self.eval()
        self.to(self.device)

    def init(self, seed):
        """Draw every weight from `torch.Generator().manual_seed(seed)` (on the
        CPU, so a seed gives the same weights on every device)."""
        gen = torch.Generator().manual_seed(int(seed))
        self.to("cpu")
        for mod in self.modules():
            if hasattr(mod, "init_weights"):
                mod.init_weights(gen)
        return self.to(self.device)

    def load_weights(self, state_dict):
        """Load a state dict (e.g. from utils/from_jax.py) onto the model's device."""
        self.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        return self

    def frames(self, episode):
        """episode["frames"] (1, s, H, W, 3) ImageNet-normalised, as a float32
        tensor on the model's device."""
        return torch.as_tensor(episode["frames"], dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------- module fns

    def frozen_prefix(self, images):
        """Frozen stem+layer1 features (NCHW), shared by the detector passes."""
        return self.detector(images, stage="frozen_prefix")

    def detr_apply(self, det_params, images, stage="all", gen=None):
        """The detector with `det_params` ({name: tensor}) in place of its
        parameters, or its own parameters when `det_params` is None; dropout
        on when a generator `gen` is given."""
        if det_params is None:
            return self.detector(images, stage=stage, gen=gen)
        return functional_call(self.detector, det_params, (images,),
                               {"stage": stage, "gen": gen})

    def fusion_apply(self, detr_out, fus_params=None, gen=None):
        """Per-frame detector outputs (s, ...) -> fusion with batch dim 1,
        with `fus_params` in place of its parameters when given."""
        keys = ("embedded_memory_features", "box_features", "pred_logits", "pred_boxes")
        x = {k: detr_out[k][None] for k in keys}
        if fus_params is None:
            return self.fusion(x, gen=gen)
        return functional_call(self.fusion, fus_params, (x,), {"gen": gen})

    def criterion(self, outputs, targets, **kw):
        """models/criterion.py::set_criterion with the config's matcher costs."""
        kw.setdefault("num_classes", self.num_classes)
        kw.setdefault("cost_class", self.cost_class)
        kw.setdefault("cost_bbox", self.cost_bbox)
        kw.setdefault("cost_giou", self.cost_giou)
        return set_criterion(outputs, targets, **kw)
