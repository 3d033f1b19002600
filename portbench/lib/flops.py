"""FLOPs of one train episode and one served episode, counted from the
reference model's own operations at a configuration's shapes.

The reference runs on the meta device under `FlopCounterMode`, which
counts the matmuls and convolutions of every pass, forward and every
order of backward (the inner gradient with its graph, the second-order
terms, the supervisor and detector passes), and nothing else. The
criterion and the path storage are replaced by elementwise stand-ins of
the same reach (every prediction reaches the loss), which move no matmul:
the counts are those of the real step. The reference keeps every
activation, so nothing is counted twice for recomputation.

`fwconv` is the fast weights' convolution work: every convolution op
outside the frozen stem+layer1, which are the trainable k>1 convs (a 1x1
conv is a matmul), in every pass and order of differentiation. At first
order that is 2·N·Ho·Wo·k²·Ci·Co for each forward, input gradient and
kernel gradient the path takes, on unpadded outputs. The double
backward's ops (the gradients of the inner pass's conv gradients) are
taken as the reference computes them, each at its own geometry; where a
kernel gradient's gradient runs as a padded convolution, its padded
positions are counted too.
"""

import contextlib

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import constants as C
from portbench.reference import task as task_mod
from portbench.reference.config import Config
from portbench.reference.task import ReferenceTask

_CONV_OPS = ("convolution", "_convolution", "convolution_backward", "cudnn_convolution")


def _stub_criterion(outputs, targets, *, num_classes, per_frame=False, episodes=None, **costs):
    logits, boxes = outputs["pred_logits"].float(), outputs["pred_boxes"].float()
    e = episodes or 1
    v = logits.logsumexp(-1).sum(-1) + boxes.sum((-1, -2))
    per_ep = v.reshape(e, -1).sum(1)
    out = {k: per_ep for k in ("loss_ce", "loss_bbox", "loss_giou")}
    out.update(cardinality_error=per_ep.detach(), class_error=per_ep.detach())
    if per_frame:
        out["_per_frame"] = {k: v.detach().reshape(e, -1)
                             for k in ("ce_num", "ce_den", "bbox_sum", "giou_sum", "num_boxes")}
    return out


def _stub_paths(state, uids, actions, rewards):
    return state, actions.long()


@contextlib.contextmanager
def _stubs():
    saved = task_mod.set_criterion, task_mod.update_and_label
    task_mod.set_criterion, task_mod.update_and_label = _stub_criterion, _stub_paths
    try:
        yield
    finally:
        task_mod.set_criterion, task_mod.update_and_label = saved


def _conv(counter):
    return sum(n for op, n in counter.get_flop_counts()["Global"].items()
               if getattr(op, "__name__", str(op)).split(".")[0] in _CONV_OPS)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops(), _conv(fc)


def count(config_dict, inner_batch=None):
    """{"train_episode": FLOPs, "serve_episode": FLOPs, "fwconv_train_episode": ...,
    "fwconv_serve_episode": ...} of the configuration, on the meta device."""
    cfg = Config(config_dict)
    task = ReferenceTask(cfg, "meta")
    size = int(cfg.MODEL.get("TEST_RESOLUTION", C.IMG_SIZE))
    e = int(inner_batch or cfg.TRAINER.get("INNER_BATCH", 1))
    frames = torch.zeros(e, C.NUM_FRAMES, size, size, 3, device="meta")
    m = task.detector.num_queries
    eps = {"frames": frames,
           "labels": torch.zeros(e, C.NUM_FRAMES, m, dtype=torch.long, device="meta"),
           "boxes": torch.zeros(e, C.NUM_FRAMES, m, 4, device="meta"),
           "valid": torch.ones(e, C.NUM_FRAMES, m, dtype=torch.bool, device="meta"),
           "actions": torch.zeros(e, C.NUM_FRAMES, dtype=torch.long, device="meta"),
           "episode_uid": torch.arange(e, device="meta")}
    params = {grp: {n: p.detach().requires_grad_(True) for n, p in mod.named_parameters()}
              for grp, mod in task.modules_by_group().items()}
    leaves = [p for d in params.values() for p in d.values()]

    def train():
        with _stubs(), torch.enable_grad():
            main, logits, _ = task._mb_fwd(params, eps, [0] * e, [None] * 4)
            loss = main.sum() + torch.log_softmax(logits, -1).sum()
            torch.autograd.grad(loss, leaves, allow_unused=True)

    def serve():
        one = frames[:1]
        if task.with_policy:  # a model without a policy takes random actions
            for s in range(1, C.NUM_FRAMES):
                task.action_logits({"frames": one[:, :s]})
        task.predict({"frames": one})

    def prefix(n):
        return lambda: task.frozen_prefix(torch.zeros(n, size, size, 3, device="meta"))

    # frozen stem+layer1 frames: a train microbatch's, and a served episode's
    # next_action at s = 1..4 (the whole detector on s frames) and predict
    prefix_frames = {"train": e * C.NUM_FRAMES,
                     "serve": (1 + 2 + 3 + 4 if task.with_policy else 0) + C.NUM_FRAMES}
    out = {}
    for name, fn, n_eps in (("train", train, e), ("serve", serve, 1)):
        total, conv = _counted(fn)
        conv_prefix = _counted(prefix(prefix_frames[name]))[1]
        out[f"{name}_episode"] = total / n_eps
        out[f"fwconv_{name}_episode"] = (conv - conv_prefix) / n_eps
    return out
