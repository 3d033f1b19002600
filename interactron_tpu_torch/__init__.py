"""PyTorch/CUDA port of interactron-tpu for NVIDIA Hopper.

The package runs every configuration of `configs/`: the adaptive
`predict`, the policy `next_action` and the second-order meta-train step
(`grads_and_metrics` and the optimizer step in `engine/trainer.py`) of
`interactron` (ResNet-50-DC5 or ViT-B/16) and `interactron_random`
(FusionXAttn), and the direct-supervision baselines `detr` and
`detr_multiframe`; it trains and evaluates them from an episode tree on
disk (`data/`, `engine/`, the entry points `train.py` and `evaluate.py`),
from MODEL.WEIGHTS (a reference `.pth` or a JAX-written `.ckpt`, `utils/`)
and over a dp x tp grid of torch.distributed ranks, with the class heads
split over tp on the served path (`parallel/`); its host tools are the
native JPEG loader (`native/`), the path storage and plots (`utils/`) and
the AI2-THOR collector (`collect/`, `collect_data.py`). It imports torch,
numpy, scipy, PIL and yaml; the JAX package `interactron_tpu` is its numerical
reference and is never imported here. Module and file names mirror
`interactron_tpu/` so each counterpart is easy to find.
"""
