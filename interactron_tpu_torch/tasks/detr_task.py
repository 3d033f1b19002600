"""Single-frame DETR baseline `detr` (counterpart of
interactron_tpu/tasks/detr_task.py): the detector alone, trained by direct
supervision.

All b*s frames of a batch go through the detector as one batch, with one
criterion call over them (one num_boxes for the batch) and loss
ce + 5*bbox + 2*giou: this baseline weights bbox 5 and giou 2, the
opposite of the interactron family's ce + 5*giou + 2*bbox.
"""

import torch

from interactron_tpu_torch.tasks.base import TaskModel


class DETRTask(TaskModel):
    needs_fusion = False

    def _loss(self, params, batch, gen):
        b, s = batch["frames"].shape[:2]
        dev = self.device
        frames = torch.as_tensor(batch["frames"], dtype=torch.float32, device=dev)
        out = self.detr_apply(params, frames.reshape(b * s, *frames.shape[2:]), gen=gen)
        targets = {k: torch.as_tensor(batch[k], device=dev).reshape(b * s, *batch[k].shape[2:])
                   for k in ("labels", "boxes", "valid")}
        losses = self.criterion({k: out[k] for k in ("pred_logits", "pred_boxes")}, targets)
        total = losses["loss_ce"] + 5.0 * losses["loss_bbox"] + 2.0 * losses["loss_giou"]
        metrics = {k: v.detach().double() for k, v in self.rename(losses, "detector").items()}
        metrics["total_loss"] = total.detach().double()
        return total, metrics

    def grads_and_metrics(self, batch, gen, path_state=None, train=True, frame_index=None):
        """({"detector": {name: grad}}, metrics, empty path state) of one
        batch; dropout on with `train` (drawn from the CPU generator `gen`);
        `frame_index` is not used."""
        leaves = self.trainable_leaves()
        with torch.enable_grad():
            total, metrics = self._loss(leaves["detector"], batch, gen if train else None)
            got = torch.autograd.grad(total, list(leaves["detector"].values()))
        return {"detector": dict(zip(leaves["detector"], got))}, metrics, {}

    @torch.no_grad()
    def eval_metrics(self, batch, gen, path_state=None, frame_index=None):
        """Test-epoch losses with dropout off: (metrics, empty path state)."""
        return self._loss(None, batch, None)[1], {}

    @torch.no_grad()
    def predict(self, episode):
        """The detector on every frame: pred_logits (1, s, Q, C+1) and
        pred_boxes (1, s, Q, 4) (the evaluators score frame 0)."""
        out = self.detr_apply(None, self.frames(episode)[0])
        return {"pred_logits": out["pred_logits"][None], "pred_boxes": out["pred_boxes"][None]}
