"""Adaptive prediction and the policy step of `interactron_random` and full
`interactron` (counterpart of interactron_tpu/tasks/interactron.py:
`InteractronRandomTask.predict`, `InteractronTask.next_action`).

Episodes are processed one at a time: the adapted conv kernels are
per-episode, and batching them needs a grouped formulation that is not
ported yet.
"""

import torch

from interactron_tpu_torch.meta import (
    clipped_sgd_step,
    learned_loss_value,
    merge_inner,
    split_inner,
)
from interactron_tpu_torch.tasks.base import TaskModel


class InteractronRandomTask(TaskModel):
    needs_fusion = True

    def adapt(self, episode):
        """One learned-loss step on the episode.

        g is the first-order gradient of ||fusion.loss|| with respect to the
        adapted detector parameters, taken at their casts to `inner_dtype`;
        the fast weights are p - clip(lr*g, +-0.01), computed in
        `inner_dtype`. The DETR q/k/v in-projections are not adapted and
        keep their (cast) values in the fast weights.

        Returns (fast weights, g, frozen prefix of the episode's frames)."""
        frames = self.frames(episode)[0]
        with torch.no_grad():
            prefix = self.frozen_prefix(frames)
        adapted_p, static_p = split_inner(dict(self.detector.named_parameters()))
        cast = (lambda t: t) if self.inner_dtype is None else (lambda t: t.to(self.inner_dtype))
        static_c = {k: cast(v) for k, v in static_p.items()}
        leaves = {k: cast(v).detach().requires_grad_(True) for k, v in adapted_p.items()}
        with torch.enable_grad():
            out = self.detr_apply(merge_inner(leaves, static_c), prefix, stage="from_prefix")
            loss = learned_loss_value(self.fusion_apply(out))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        g = dict(zip(leaves, grads))
        fast = clipped_sgd_step(adapted_p, g, self.adaptive_lr, dtype=self.inner_dtype)
        return merge_inner(fast, static_c), g, prefix

    def predict(self, episode):
        """Adapt on the episode, then detect on frame 0 with the fast weights:
        pred_logits (1, 1, Q, C+1) and pred_boxes (1, 1, Q, 4)."""
        fast, _, prefix = self.adapt(episode)
        with torch.no_grad():
            out0 = self.detr_apply(fast, prefix[0:1], stage="from_prefix")
        return {"pred_logits": out0["pred_logits"][None], "pred_boxes": out0["pred_boxes"][None]}


class InteractronTask(InteractronRandomTask):
    """Full interactron: learned policy + learned loss."""

    @torch.no_grad()
    def next_action(self, episode):
        """Argmax of the fusion's action logits at token s-1, for an episode
        of s frames (1 <= s <= 4)."""
        frames = self.frames(episode)[0]
        s = frames.shape[0]
        fus = self.fusion_apply(self.detr_apply(None, frames))
        return torch.argmax(fus["actions"][0, s - 1], dim=-1)
