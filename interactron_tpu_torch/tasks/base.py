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

import contextlib
import os
import warnings

import torch
from torch import nn
from torch.func import functional_call

from interactron_tpu_torch.models.criterion import set_criterion
from interactron_tpu_torch.models.deformable_detr import BACKBONES as DEFORMABLE, DeformableDETR
from interactron_tpu_torch.models.detr import DETR
from interactron_tpu_torch.models.fusion import build_fusion
from interactron_tpu_torch.models.layers import (
    MultiHeadAttention,
    episode_shift_convs,
    im2col_convs,
)
from interactron_tpu_torch.ops.flash_attention import remat_dropout_scope
from interactron_tpu_torch.utils import constants as C
from interactron_tpu_torch.utils import profiling
from interactron_tpu_torch.utils.cuda_graphs import GraphCache, PinnedStaging
from interactron_tpu_torch.utils.checkpoint import load_pretrained

_DTYPES = {None: torch.float32, "float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None):
    """`device` as a torch.device: CUDA by default, and an error when CUDA is
    asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def sub_generator(gen):
    """A CPU generator seeded from `gen`: one dropout stream per pass."""
    return torch.Generator().manual_seed(int(torch.randint(0, 2**62, (), generator=gen)))


def build_detector(m, dtype):
    """The detector of config section MODEL `m`: Deformable DETR for its
    backbones (models/deformable_detr.py), DETR otherwise."""
    common = dict(
        num_classes=m.NUM_CLASSES,
        d_model=int(m.get("D_MODEL", 256)),
        num_heads=int(m.get("DETR_NUM_HEADS", 8)),
        num_encoder_layers=int(m.get("NUM_ENCODER_LAYERS", 6)),
        num_decoder_layers=int(m.get("NUM_DECODER_LAYERS", 6)),
        dropout_rate=float(m.get("DETR_DROPOUT", 0.1)),
        backbone=m.get("BACKBONE", "resnet50"),
        dtype=dtype,
    )
    if common["backbone"] in DEFORMABLE:
        return DeformableDETR(num_queries=int(m.get("NUM_QUERIES", 300)),
                              ff_dim=int(m.get("DETR_FF_DIM", 1024)),
                              num_levels=int(m.get("NUM_FEATURE_LEVELS", 4)),
                              num_points=int(m.get("NUM_POINTS", 4)), **common)
    return DETR(num_queries=int(m.get("NUM_QUERIES", C.NUM_QUERIES)),
                ff_dim=int(m.get("DETR_FF_DIM", 2048)),
                image_size=int(m.get("TEST_RESOLUTION", C.IMG_SIZE)), **common)


class TaskModel(nn.Module):
    needs_fusion = False
    # rows of a transient path state when the caller threads none; the
    # tasks without a policy keep no path state
    default_path_rows = 0

    def __init__(self, config, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        m = config.MODEL
        self.dtype = _DTYPES[m.get("DTYPE")]
        self.detector = build_detector(m, self.dtype)
        self.fusion = build_fusion(config, self.dtype) if self.needs_fusion else None
        # MODEL.FLASH_ATTENTION is on unless the config says False (CUDA is
        # the port's accelerator); MODEL.CHUNKED_ATTENTION is off unless set
        flash = bool(m.get("FLASH_ATTENTION", True))
        chunked = bool(m.get("CHUNKED_ATTENTION", False))
        for mod in self.modules():
            if isinstance(mod, MultiHeadAttention):
                mod.flash, mod.chunked = flash, chunked
        self.num_classes = m.NUM_CLASSES
        self.img_size = int(m.get("TEST_RESOLUTION", C.IMG_SIZE))
        self.max_boxes = min(C.MAX_BOXES, self.detector.num_queries)
        self.cost_class = float(m.get("SET_COST_CLASS", 1.0))
        self.cost_bbox = float(m.get("SET_COST_BBOX", 5.0))
        self.cost_giou = float(m.get("SET_COST_GIOU", 2.0))
        self.adaptive_lr = float(m.get("ADAPTIVE_LR", 1e-3))
        inner = m.get("INNER_DTYPE")
        # the inner step runs in the compute dtype unless that is fp32
        self.inner_dtype = (_DTYPES[inner] if inner is not None
                            else (self.dtype if self.dtype != torch.float32 else None))
        # episodes a train-step microbatch runs in one batched pass
        trainer = config.get("TRAINER")
        self.inner_batch = int(trainer.get("INNER_BATCH", 1)) if trainer is not None else 1
        # the JAX package's conv and memory switches, with its defaults and
        # precedence. Every pass of the modules runs under `_switches`:
        # dropout saves no mask (MODEL.REMAT_DROPOUT) and every trainable
        # k>1 conv runs as im2col (MODEL.IM2COL_CONV). The fast-weight
        # passes run under `_econv_scope` (ADAPTED_IM2COL over SHIFT_CONV),
        # and the train passes checkpoint their layers under TRAINER.REMAT
        # (`use_remat`). MODEL.INNER_SHIFT_CONV is not read (ROADMAP).
        self.remat_dropout = bool(m.get("REMAT_DROPOUT", True))
        self.im2col_conv = bool(m.get("IM2COL_CONV", False))
        self.adapted_im2col = bool(m.get("ADAPTED_IM2COL", False))
        self.adapted_shift9 = bool(m.get("SHIFT_CONV", True)) and not self.adapted_im2col
        self.use_remat = bool(trainer.get("REMAT", False)) if trainer is not None else False
        # the shared-weight, no-grad passes replay CUDA graphs
        # (utils/cuda_graphs.py); the frames reach the card through a pinned
        # staging buffer
        self._graphs = GraphCache()
        self._staging = PinnedStaging()
        self.requires_grad_(False)
        self.eval()
        self.to(self.device)

    def init(self, seed):
        """Draw every weight from `torch.Generator().manual_seed(seed)` (on the
        CPU, so a seed gives the same weights on every device), then load
        MODEL.WEIGHTS over them where the file exists
        (utils/checkpoint.py::load_pretrained), or warn as the JAX package
        does where it does not."""
        gen = torch.Generator().manual_seed(int(seed))
        self.to("cpu")
        for mod in self.modules():
            if hasattr(mod, "init_weights"):
                mod.init_weights(gen)
        weights = self.config.MODEL.get("WEIGHTS")
        if weights:
            if os.path.exists(weights):
                load_pretrained(weights, self)
            else:
                warnings.warn(f"MODEL.WEIGHTS not found, random init: {weights}")
        return self.to(self.device)

    def load_weights(self, state_dict):
        """Load a state dict (e.g. from utils/from_jax.py) onto the model's device."""
        self.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        return self

    def init_path_state(self, num_episodes):
        return {}

    def modules_by_group(self):
        """{"detector": module, "fusion": module}, without the fusion when
        the task has none."""
        return {grp: mod for grp, mod in (("detector", self.detector), ("fusion", self.fusion))
                if mod is not None}

    def trainable_leaves(self):
        """{group: {name: leaf}}: leaves that share the parameters' storage
        and require grad."""
        return {grp: {n: p.detach().requires_grad_(True) for n, p in mod.named_parameters()}
                for grp, mod in self.modules_by_group().items()}

    def microbatches(self, b):
        """Slices of a batch of `b` episodes into JAX's microbatches
        (`scan_microbatches`): max(1, b // INNER_BATCH) equal chunks. A
        batch they do not divide raises where JAX's assert fires (e.g. a
        test-epoch tail of 9 at INNER_BATCH 4: 2 chunks of 4.5)."""
        num_micro = max(1, b // max(1, self.inner_batch))
        if b % num_micro:
            raise ValueError(f"batch {b} not divisible by {num_micro} microbatches "
                             f"(INNER_BATCH {self.inner_batch})")
        size = b // num_micro
        return [slice(i * size, (i + 1) * size) for i in range(num_micro)]

    def episodes(self, batch, idx):
        """Episodes `idx` (a slice) of a numpy batch as tensors on the task's
        device: frames (E, 5, H, W, 3) float32; labels, boxes, valid,
        actions and episode_uid (E,) as given."""
        dev = self.device
        with profiling.span("mb.upload"):
            eps = {k: profiling.upload("batch", batch[k][idx], dev)
                   for k in ("frames", "labels", "boxes", "valid", "actions", "episode_uid")}
        eps["frames"] = eps["frames"].float()
        return eps

    def frames(self, episodes):
        """episodes["frames"] (E, s, H, W, 3) ImageNet-normalised, as a float32
        tensor on the model's device, copied to the card from a pinned
        buffer without waiting for it."""
        with profiling.span("frames.upload"):
            return self._staging.upload("frames", episodes["frames"], self.device,
                                        torch.float32)

    def _econv_scope(self):
        """Conv scope of the fast-weight detector passes."""
        if self.adapted_im2col:
            return im2col_convs()
        return episode_shift_convs() if self.adapted_shift9 else contextlib.nullcontext()

    @contextlib.contextmanager
    def _switches(self):
        """MODEL.REMAT_DROPOUT and MODEL.IM2COL_CONV around a pass."""
        with remat_dropout_scope(self.remat_dropout), (
                im2col_convs() if self.im2col_conv else contextlib.nullcontext()):
            yield

    # ------------------------------------------------------------- module fns

    def frozen_prefix(self, images):
        """Frozen stem+layer1 features (NCHW), shared by the detector passes."""
        return self.detector(images, stage="frozen_prefix")

    def detr_apply(self, det_params, images, stage="all", gen=None, decoder_gen=None,
                   remat=False):
        """The detector with `det_params` ({name: tensor}) in place of its
        parameters, or its own parameters when `det_params` is None; dropout
        on when a generator `gen` is given, and in the decoder also with
        `decoder_gen` alone; its layers checkpointed with `remat` under
        TRAINER.REMAT (JAX's `remat=train`). With its own parameters and no
        dropout the pass may replay CUDA graphs (`GraphCache.run`)."""
        kw = {"stage": stage, "gen": gen, "decoder_gen": decoder_gen,
              "remat": remat and self.use_remat}
        with self._switches():
            if det_params is None:
                if gen is None and decoder_gen is None:
                    return self._graphs.run(self.detector, lambda x: self.detector(x, **kw),
                                            (images,), **kw)
                return self.detector(images, **kw)
            return functional_call(self.detector, det_params, (images,), kw)

    def fusion_apply(self, detr_out, fus_params=None, gen=None, episodes=1, remat=False):
        """Per-frame detector outputs of `episodes` episodes, (E*s, ...)
        episode-major -> the fusion over a batch of E episodes, with
        `fus_params` in place of its parameters when given; its blocks
        checkpointed as `detr_apply`'s layers, its own-parameter passes
        without dropout replayed as `detr_apply`'s."""
        keys = ("embedded_memory_features", "box_features", "pred_logits", "pred_boxes")
        x = {k: detr_out[k].reshape(episodes, -1, *detr_out[k].shape[1:]) for k in keys}
        kw = {"gen": gen, "remat": remat and self.use_remat}
        with self._switches():
            if fus_params is None:
                if gen is None:
                    return self._graphs.run(
                        self.fusion, lambda *t: self.fusion(dict(zip(keys, t)), **kw),
                        tuple(x[k] for k in keys), **kw)
                return self.fusion(x, **kw)
            return functional_call(self.fusion, fus_params, (x,), kw)

    def criterion(self, outputs, targets, **kw):
        """models/criterion.py::set_criterion with the config's matcher costs."""
        kw.setdefault("num_classes", self.num_classes)
        kw.setdefault("cost_class", self.cost_class)
        kw.setdefault("cost_bbox", self.cost_bbox)
        kw.setdefault("cost_giou", self.cost_giou)
        return set_criterion(outputs, targets, **kw)

    @staticmethod
    def rename(losses, prefix):
        """k.replace("loss", f"loss_{prefix}"): the *_error keys keep their
        names."""
        return {k.replace("loss", f"loss_{prefix}"): v for k, v in losses.items()}
