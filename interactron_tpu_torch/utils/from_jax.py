"""Weight bridge from the JAX package's (params, frozen) trees to this
package's state dict (the counterpart of utils/convert_weights.py, in the
other direction).

Flax tree paths become dotted names ({"detector": {"backbone": {"conv1":
{"kernel": ...}}}} -> "detector.backbone.conv1.weight"), with:
  * conv kernels HWIO -> OIHW and Dense kernels (in, out) -> (out, in),
    both named `weight`;
  * LayerNorm `scale` -> `weight`;
  * the frozen collection (stem+layer1 kernels, FrozenBatchNorm tensors)
    merged into the same names, where the port keeps them as buffers.
Everything else keeps its name and layout: the detector of every backbone
(ResNet-50-DC5, the tiny one, ViT-B/16 with its `patch_embed` Dense and
`pos_embed` table) and both fusion variants (FusionGPT; FusionXAttn's
`action_tokens`, `query_embed`, `transformer.*` and `heads.*`) map leaf
for leaf; a tree without "fusion" (the `detr` task) maps the detector
alone.
"""

import numpy as np


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _leaf(path, value):
    *mods, name = path
    if name == "kernel":
        name = "weight"
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {value.shape}")
    elif name == "scale":
        name = "weight"
    return ".".join((*mods, name)), np.array(value, dtype=np.float32, order="C")


def from_jax(params_np, frozen_np):
    """{"detector": ..., "fusion": ...} params and {"detector": ...} frozen
    trees of numpy arrays -> {dotted name: float32 numpy array}."""
    state = {}
    for tree in (params_np, frozen_np):
        for path, value in _flatten(tree):
            name, arr = _leaf(path, value)
            if name in state:
                raise ValueError(f"duplicate weight {name}")
            state[name] = arr
    return state
