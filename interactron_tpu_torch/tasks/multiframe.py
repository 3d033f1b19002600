"""Multi-frame baseline `detr_multiframe` (counterpart of
interactron_tpu/tasks/multiframe.py): DETR and the FusionGPT refinement,
trained by direct supervision, with no adaptation.

A train step splits its batch into microbatches of TRAINER.INNER_BATCH
episodes (`TaskModel.microbatches`), each one batched pass (<-
`_microbatch_loss:43-55`): the detector on its E*5 frames, in eval mode
except its decoder; the fusion, in train mode, over the E episodes,
refining the logits and boxes of all their frames; one criterion call
giving each episode's own losses; loss ce + 5*giou + 2*bbox summed over
the episodes, with one `autograd.grad` a microbatch. The test-epoch losses
run the whole batch as one pass, as JAX's `eval_metrics` does.
"""

import torch

from interactron_tpu_torch.tasks.base import TaskModel, sub_generator

_KEYS = ("loss_ce", "loss_bbox", "loss_giou", "cardinality_error", "class_error")


class MultiFrameTask(TaskModel):
    needs_fusion = True

    def _microbatch_loss(self, params, eps, dec_gen=None, fus_gen=None):
        """(totals (E,), losses {key: (E,)}) of E episodes; dropout in the
        detector's decoder with `dec_gen` and in the fusion with `fus_gen`."""
        e = eps["frames"].shape[0]
        out = self.detr_apply(params["detector"], eps["frames"].flatten(0, 1),
                              decoder_gen=dec_gen)
        fus = self.fusion_apply(out, params["fusion"], gen=fus_gen, episodes=e)
        losses = self.criterion({"pred_logits": fus["pred_logits"].flatten(0, 1),
                                 "pred_boxes": fus["pred_boxes"].flatten(0, 1)},
                                {k: eps[k].flatten(0, 1) for k in ("labels", "boxes", "valid")},
                                episodes=e)
        total = losses["loss_ce"] + 5.0 * losses["loss_giou"] + 2.0 * losses["loss_bbox"]
        return total, losses

    def _run(self, batch, gen, train, with_grads):
        b = batch["frames"].shape[0]
        params = (self.trainable_leaves() if with_grads else
                  {grp: dict(mod.named_parameters())
                   for grp, mod in self.modules_by_group().items()})
        names = [(grp, n) for grp, d in params.items() for n in d]
        leaves = [params[grp][n] for grp, n in names]
        grads = {grp: {n: torch.zeros_like(p) for n, p in d.items()} for grp, d in params.items()}
        m = {}
        # the test epoch's losses: the whole batch in one pass
        for mb in self.microbatches(b) if with_grads else [slice(0, b)]:
            eps = self.episodes(batch, mb)
            gens = (sub_generator(gen), sub_generator(gen)) if train else ()
            with torch.set_grad_enabled(with_grads):
                total, losses = self._microbatch_loss(params, eps, *gens)
                total = total.sum()
            if with_grads:
                got = torch.autograd.grad(total, leaves, allow_unused=True)
                for (grp, name), g in zip(names, got):
                    if g is not None:
                        grads[grp][name] += g
            for k, v in [*((k, losses[k]) for k in _KEYS), ("total_loss", total)]:
                m[k] = m.get(k, 0.0) + v.detach().double().sum()
        metrics = self.rename({k: m[k] / b for k in _KEYS}, "detector")
        metrics["total_loss"] = m["total_loss"] / b
        return (grads if with_grads else None), metrics

    def grads_and_metrics(self, batch, gen, path_state=None, train=True, frame_index=None):
        """Gradients of the summed episode losses ({"detector": ...,
        "fusion": ...}), the mean metrics (0-d float64 tensors on the task's
        device) and an empty path state. batch as
        InteractronTask.grads_and_metrics takes it; `gen` (a CPU
        torch.Generator) draws each microbatch's dropout streams with
        `train`; `frame_index` is not used."""
        grads, metrics = self._run(batch, gen, train, with_grads=True)
        return grads, metrics, {}

    def eval_metrics(self, batch, gen, path_state=None, frame_index=None):
        """Test-epoch losses with dropout off: (metrics, empty path state)."""
        return self._run(batch, gen, False, with_grads=False)[1], {}

    @torch.no_grad()
    def predict(self, episode):
        """Detector then fusion, no adaptation: pred_logits (1, s, Q, C+1)
        and pred_boxes (1, s, Q, 4)."""
        fus = self.fusion_apply(self.detr_apply(None, self.frames(episode)[0]))
        return {"pred_logits": fus["pred_logits"], "pred_boxes": fus["pred_boxes"]}
