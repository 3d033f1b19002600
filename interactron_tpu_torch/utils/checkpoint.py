"""Checkpoints (counterpart of interactron_tpu/utils/checkpoint.py), as
`torch.save` files read back with `torch.load(weights_only=True)`.

  * `save_state` / `load_state`: the whole train state, for resume: the
    task's parameters and buffers (the FrozenBatchNorm statistics and the
    frozen stem+layer1 kernels, JAX's `frozen` collection), both Adam
    states, the policy path state, `epoch` and `tokens`;
  * `save_checkpoint` / `load_checkpoint`: the weights alone, for the
    evaluator; the load is partial (strict=False: names missing from the
    file, or of another shape, keep the task's values);
  * `RunningAverage`: the uniform weight average of the last SAVE_WINDOW
    epochs, accumulated in fp64 and returned in fp32.

JAX's flax-msgpack checkpoints are not read here; `utils/from_jax.py`
carries JAX weights across as numpy arrays.
"""

import os

import torch


def _save(path, blob):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(blob, path)


def save_checkpoint(path, task, params=None):
    """The task's state dict, with `params` ({name: tensor}) in place of its
    parameters when given (the running average)."""
    state = {k: v.detach().cpu() for k, v in task.state_dict().items()}
    state.update({k: v.detach().cpu() for k, v in (params or {}).items()})
    _save(path, {"model": state})


def load_checkpoint(path, task):
    """Copy the file's weights into `task` wherever name and shape agree;
    returns the names that were loaded."""
    loaded = torch.load(path, map_location="cpu", weights_only=True)["model"]
    own = task.state_dict()
    names = [k for k, v in loaded.items() if k in own and own[k].shape == v.shape]
    with torch.no_grad():
        for k in names:
            own[k].copy_(loaded[k])
    return names


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
