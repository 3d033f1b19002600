"""Checkpoints (counterpart of interactron_tpu/utils/checkpoint.py), as
`torch.save` files read back with `torch.load(weights_only=True)`.

  * `save_state` / `load_state`: the whole train state, for resume: the
    task's parameters and buffers (the FrozenBatchNorm statistics and the
    frozen stem+layer1 kernels, JAX's `frozen` collection), both Adam
    states, the policy path state, `epoch` and `tokens`;
  * `save_checkpoint` / `load_checkpoint`: the weights alone, for the
    evaluator; the load is partial (strict=False: names missing from the
    file, or of another shape, keep the task's values). It also reads the
    flax-msgpack files the JAX package writes (its `detector.ckpt`, a
    converted `.ckpt`): {"params", "frozen"} or a bare params tree, named
    by `utils/from_jax.py`;
  * `load_pretrained`: MODEL.WEIGHTS at init, a reference `.pth`/`.pt`
    converted on the fly (utils/convert_weights.py), anything else read as
    `load_checkpoint` reads it;
  * `RunningAverage`: the uniform weight average of the last SAVE_WINDOW
    epochs, accumulated in fp64 and returned in fp32.
"""

import os

import torch

from interactron_tpu_torch.utils import convert_weights, flax_msgpack
from interactron_tpu_torch.utils.from_jax import from_jax

_ZIP_MAGIC = b"PK\x03\x04"  # torch.save's zip container


def _save(path, blob):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(blob, path)


def save_weights(path, state):
    """{name: tensor} as the `{"model": ...}` file `load_checkpoint` reads."""
    _save(path, {"model": {k: v.detach().cpu() for k, v in state.items()}})


def save_checkpoint(path, task, params=None):
    """The task's state dict, with `params` ({name: tensor}) in place of its
    parameters when given (the running average)."""
    state = dict(task.state_dict())
    state.update(params or {})
    save_weights(path, state)


def read_weights(path):
    """{name: tensor or array} of a weights file, by its first bytes: a
    torch zip holds this package's {"model": state dict}; anything else is
    read as flax msgpack, whose {"params", "frozen"} trees (or bare params
    tree) are named by `from_jax`."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == _ZIP_MAGIC:
        return torch.load(path, map_location="cpu", weights_only=True)["model"]
    tree = flax_msgpack.read(path)
    if not (isinstance(tree, dict) and "params" in tree):
        tree = {"params": tree}
    return from_jax(tree["params"], tree.get("frozen") or {})


def merge_weights(task, loaded):
    """Copy `loaded` ({name: tensor or array}) into `task` wherever name and
    shape agree, in the task's own dtypes; returns the names loaded."""
    own = task.state_dict()
    names = [k for k, v in loaded.items() if k in own and tuple(own[k].shape) == tuple(v.shape)]
    with torch.no_grad():
        for k in names:
            own[k].copy_(torch.as_tensor(loaded[k]))
    return names


def load_checkpoint(path, task):
    """Copy a weights file (`read_weights`) into `task` wherever name and
    shape agree; returns the names that were loaded."""
    return merge_weights(task, read_weights(path))


def load_pretrained(path, task):
    """MODEL.WEIGHTS into `task` (the JAX package's `load_pretrained`): a
    `.pth`/`.pt` file holds a reference state dict (DETR with an optional
    fusion, or a ViT-B/16 resized to the task's position grid), converted
    by utils/convert_weights.py; any other file is read by `read_weights`.
    The merge is partial by name and shape, so a detector-only file leaves
    the fusion as drawn. Returns the names loaded."""
    if path.endswith((".pth", ".pt")):
        sd = convert_weights.read_torch(path)
        pos = task.state_dict().get("detector.backbone.pos_embed")
        grid = None if pos is None else int(round(pos.shape[0] ** 0.5))
        loaded = convert_weights.convert_reference(sd, grid=grid)
    else:
        loaded = read_weights(path)
    return merge_weights(task, loaded)


def save_state(path, task, opts, path_state, epoch, tokens):
    """The train state: weights, each optimizer's state dict, the path
    state, the epoch just finished and the frames seen."""
    _save(path, {
        "model": {k: v.detach().cpu() for k, v in task.state_dict().items()},
        "opt": {name: opt.state_dict() for name, opt in opts.items()},
        "path_state": {k: v.detach().cpu() for k, v in path_state.items()},
        "epoch": int(epoch),
        "tokens": int(tokens),
    })


def load_state(path, task, opts):
    """Restore what `save_state` wrote into `task` and `opts` (strictly: a
    missing or unexpected name raises). Returns (path state on the task's
    device, epoch, tokens)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    task.load_state_dict(state["model"])
    for name, opt in opts.items():
        opt.load_state_dict(state["opt"][name])
    path_state = {k: v.to(task.device) for k, v in state["path_state"].items()}
    return path_state, state["epoch"], state["tokens"]


class RunningAverage:
    """Uniform running average of parameter dicts (the reference's
    record_checkpoint with w = 1/SAVE_WINDOW)."""

    def __init__(self):
        self.acc = None

    def add(self, params, w):
        """Accumulate w * params ({name: tensor}) in fp64."""
        with torch.no_grad():
            if self.acc is None:
                self.acc = {k: w * v.detach().double() for k, v in params.items()}
            else:
                for k, v in params.items():
                    self.acc[k] += w * v.detach().double()

    def value(self, like=None):
        """The average in fp32, or `like` when nothing was added."""
        if self.acc is None:
            return like
        return {k: v.float() for k, v in self.acc.items()}
