"""Adaptive prediction, the policy step and the second-order meta-train step
of `interactron_random` and full `interactron` (counterpart of
interactron_tpu/tasks/interactron.py).

A train step splits its batch into microbatches of TRAINER.INNER_BATCH
episodes (`TaskModel.microbatches`, <- `scan_microbatches`). Each runs as
one batched pass over its E episodes (`_mb_fwd`, <- `_mb_fwd:189-197`, the
vmap of `_episode_fwd:74-185`), every episode with its own fast weights:
the adapted weights are expanded to a leading episode axis (E, ...), a view
of the shared ones, and the inner gradient is taken with respect to that
expansion, so episode e's g is the gradient of its own inner loss.

  supervisor (second-order) path, detector params stopped:
      g     = grad_a ||fusion.loss(detr(a, frames))||, a = cast(sg(det))
      fast2 = a - clip(lr*g, +-0.01)
      L_sup = criterion(detr(fast2, frames), all 5 frames' targets)
      -> d L_sup / d fusion flows through g (create_graph=True)
  detector (first-order) path, g stopped:
      fast1 = cast(det) - clip(lr*sg(g), +-0.01)
      L_det = criterion(detr(fast1, frame[ridx]), targets[ridx]), ridx ~ U{0..4}
      (a batch of E single frames, each episode's own ridx)
  policy (interactron only): the frame-0 loss of the supervisor pass is the
      path reward; the best-path labels are read after the storage update
      of the microbatch's episodes, and their cross entropy with the action
      logits is added to the loss.

The criterion normalises each episode by its own box count. The DETR q/k/v
in-projections are not adapted and stay shared; their casts are not
stopped, so outer gradients reach them through every pass. The inner pass
runs under `flash_disabled()`, so its attentions take the second-order
kernels. Each microbatch takes one `autograd.grad` of its summed loss, and
the gradients are summed over microbatches by hand.
"""

from contextlib import nullcontext

import torch
import torch.nn.functional as F

from interactron_tpu_torch.meta import (
    clipped_sgd_step,
    learned_loss_value,
    merge_inner,
    split_inner,
)
from interactron_tpu_torch.models.deformable_detr import DeformableDETR
from interactron_tpu_torch.ops.attention import flash_disabled
from interactron_tpu_torch.tasks.base import TaskModel, sub_generator
from interactron_tpu_torch.utils import constants as C
from interactron_tpu_torch.utils import profiling
from interactron_tpu_torch.utils.device_path_storage import init_path_state, update_and_label

_SUP_KEYS = ["loss_ce", "loss_bbox", "loss_giou", "cardinality_error", "class_error"]


def _weighted(losses):
    """ce + 5*giou + 2*bbox."""
    return losses["loss_ce"] + 5.0 * losses["loss_giou"] + 2.0 * losses["loss_bbox"]


class InteractronRandomTask(TaskModel):
    needs_fusion = True
    with_policy = False
    default_path_rows = 4096

    def init_path_state(self, num_episodes):
        return init_path_state(num_episodes, self.device)

    def _cast(self, t):
        return t if self.inner_dtype is None else t.to(self.inner_dtype)

    def _per_episode(self, adapted, e):
        """Stopped casts of the adapted weights expanded to (E, ...): views of
        the shared storage, and the leaves the inner gradient is taken
        against."""
        return {k: self._cast(v.detach()).expand(e, *v.shape).requires_grad_(True)
                for k, v in adapted.items()}

    def adapt(self, episodes):
        """One learned-loss step on each of E episodes of s frames
        (episodes["frames"] (E, s, H, W, 3)).

        Episode e's g is the first-order gradient of its ||fusion.loss||
        with respect to its copy of the adapted detector parameters, taken
        at their casts to `inner_dtype`; its fast weights are p - clip(lr*g,
        +-0.01), computed in `inner_dtype`. The DETR q/k/v in-projections
        are not adapted and keep their shared (cast) values in the fast
        weights.

        Returns (fast weights, g, frozen prefix of the E*s frames); the
        adapted entries of both dicts are (E, ...)."""
        with profiling.span("adapt"):
            frames = self.frames(episodes)
            e = frames.shape[0]
            with torch.no_grad(), profiling.span("adapt.prefix"):
                prefix = self.frozen_prefix(frames.flatten(0, 1))
            adapted_p, static_p = split_inner(dict(self.detector.named_parameters()))
            static_c = {k: self._cast(v) for k, v in static_p.items()}
            leaves = self._per_episode(adapted_p, e)
            with torch.enable_grad():
                with profiling.span("adapt.inner"):
                    out = self.detr_apply(merge_inner(leaves, static_c), prefix,
                                          stage="from_prefix")
                    loss = learned_loss_value(self.fusion_apply(out, episodes=e))
                with profiling.span("adapt.inner_grad"):
                    grads = torch.autograd.grad(loss, list(leaves.values()))
            g = dict(zip(leaves, grads))
            with profiling.span("adapt.step"):
                fast = clipped_sgd_step(adapted_p, g, self.adaptive_lr, dtype=self.inner_dtype)
            return merge_inner(fast, static_c), g, prefix

    def predict(self, episodes):
        """Adapt on each of E episodes, then detect on its frame 0 with its
        own fast weights: pred_logits (E, 1, Q, C+1) and pred_boxes
        (E, 1, Q, 4)."""
        e = len(episodes["frames"])
        with profiling.span("serve.predict", episodes=e):
            fast, _, prefix = self.adapt(episodes)
            with torch.no_grad(), self._econv_scope(), profiling.span("predict.detect"):
                out0 = self.detr_apply(fast, prefix.unflatten(0, (e, -1))[:, 0],
                                       stage="from_prefix")
            return {"pred_logits": out0["pred_logits"][:, None],
                    "pred_boxes": out0["pred_boxes"][:, None]}

    # ------------------------------------------------------------ train step

    def _mb_fwd(self, params, eps, ridx, gens, second_order, train):
        """(main losses (E,), action logits (E, 4, 4), aux) of a microbatch of E
        episodes in one batched pass. `ridx` holds each episode's frame of
        the detector pass; `gens` the dropout generators of the inner
        detector, fusion, supervisor and detector passes (all None without
        dropout). With `second_order` the inner gradient keeps its graph, so
        the supervisor loss reaches the fusion through g. With `train` the
        passes checkpoint their layers under TRAINER.REMAT. The supervisor
        and detector passes (the fast weights) run under the fast-weight
        conv scope."""
        det_p, fus_p = params["detector"], params["fusion"]
        e = eps["frames"].shape[0]
        adapted_p, static_p = split_inner(det_p)
        adapted_base = self._per_episode(adapted_p, e)
        static_c = {k: self._cast(v) for k, v in static_p.items()}  # not stopped
        with torch.no_grad(), profiling.span("mb.prefix"):
            prefix = self.frozen_prefix(eps["frames"].flatten(0, 1))

        with torch.enable_grad():
            with flash_disabled() if second_order else nullcontext(), profiling.span("mb.inner"):
                out = self.detr_apply(merge_inner(adapted_base, static_c), prefix,
                                      stage="from_prefix", gen=gens[0], remat=train)
                fus_out = self.fusion_apply(out, fus_p, gen=gens[1], episodes=e, remat=train)
            with profiling.span("mb.inner_grad"):
                grads = torch.autograd.grad(learned_loss_value(fus_out),
                                            list(adapted_base.values()),
                                            create_graph=second_order)
        g = dict(zip(adapted_base, grads))

        with torch.set_grad_enabled(second_order):
            with profiling.span("mb.supervisor"):
                # supervisor (second-order) path on all frames
                fast2 = merge_inner(clipped_sgd_step(adapted_base, g, self.adaptive_lr),
                                    static_c)
                with self._econv_scope():
                    post = self.detr_apply(fast2, prefix, stage="from_prefix", gen=gens[2],
                                           remat=train)
                targets = {k: eps[k].flatten(0, 1) for k in ("labels", "boxes", "valid")}
                sup = self.criterion({k: post[k] for k in ("pred_logits", "pred_boxes")},
                                     targets, per_frame=True, episodes=e)
                pf = sup.pop("_per_frame")
                # frame-0 ground-truth loss of the adapted detector: the policy reward
                nb0 = pf["num_boxes"][:, 0].clamp(min=1.0)
                reward = (pf["ce_num"][:, 0] / pf["ce_den"][:, 0]
                          + 5.0 * (pf["giou_sum"][:, 0] / nb0)
                          + 2.0 * (pf["bbox_sum"][:, 0] / nb0)).detach()

            with profiling.span("mb.detector"):
                # detector (first-order) path, each episode on its own frame ridx
                g_stopped = {k: v.detach() for k, v in g.items()}
                fast1 = merge_inner(clipped_sgd_step(adapted_p, g_stopped, self.adaptive_lr,
                                                     dtype=self.inner_dtype), static_c)
                rows = profiling.upload("frame_rows",
                                        torch.arange(e) * C.NUM_FRAMES + torch.as_tensor(ridx),
                                        prefix.device)
                with self._econv_scope():
                    det_out = self.detr_apply(fast1, prefix[rows], stage="from_prefix",
                                              gen=gens[3], remat=train)
                det = self.criterion({k: det_out[k] for k in ("pred_logits", "pred_boxes")},
                                     {k: v[rows] for k, v in targets.items()}, episodes=e)
        main = _weighted(sup) + _weighted(det)
        aux = {"reward": reward, "sup": {k: v.detach() for k, v in sup.items()},
               "det": {k: v.detach() for k, v in det.items()}}
        return main, fus_out["actions"], aux

    def _policy_piece(self, logits, aux, eps, path_state):
        """(loss_path (E,), new path state): update the path storage with the
        microbatch's rewards, then the cross entropy of each episode's action
        logits with its best-path labels read after the update (<-
        `_policy_piece`)."""
        if not self.with_policy:
            return torch.zeros(logits.shape[0], device=logits.device), path_state
        path_state, best = update_and_label(path_state, eps["episode_uid"],
                                            eps["actions"][:, :C.NUM_ACTIONS], aux["reward"])
        onehot = F.one_hot(best, C.NUM_ACTIONS).to(logits.dtype)
        loss_path = -(onehot * F.log_softmax(logits, -1)).sum((1, 2)) / C.NUM_ACTIONS
        return loss_path, path_state

    def _run(self, batch, gen, path_state, train, frame_index, with_grads):
        b = batch["frames"].shape[0]
        params = (self.trainable_leaves() if with_grads else
                  {grp: dict(mod.named_parameters())
                   for grp, mod in self.modules_by_group().items()})
        names = [(grp, n) for grp, d in params.items() for n in d]
        leaves = [params[grp][n] for grp, n in names]
        if path_state is None and self.with_policy:
            path_state = self.init_path_state(self.default_path_rows)
        m = {}
        grads = {grp: {n: torch.zeros_like(p) for n, p in d.items()} for grp, d in params.items()}
        for mb in self.microbatches(b):
            with profiling.span("train.microbatch", episodes=mb.stop - mb.start):
                eps = self.episodes(batch, mb)
                ridx = [int(frame_index[i]) if frame_index is not None
                        else int(torch.randint(0, C.NUM_FRAMES, (), generator=gen))
                        for i in range(mb.start, mb.stop)]
                gens = [sub_generator(gen) if train else None for _ in range(4)]
                main, logits, aux = self._mb_fwd(params, eps, ridx, gens, with_grads, train)
                with torch.set_grad_enabled(with_grads), profiling.span("mb.policy"):
                    loss_path, path_state = self._policy_piece(logits, aux, eps, path_state)
                    total = main.sum() + loss_path.sum()
                if with_grads:
                    # one autograd.grad a microbatch, summed by hand: accumulating
                    # in .grad across backward calls counted an episode's
                    # action-token gradient twice (torch 2.13, CPU); the sum is
                    # held against JAX in tests/test_torch_port_{train,batching}.py
                    with profiling.span("mb.outer_grad"):
                        got = torch.autograd.grad(total, leaves, allow_unused=True)
                with profiling.span("mb.accumulate"):
                    if with_grads:
                        for (grp, name), g in zip(names, got):
                            if g is not None:
                                grads[grp][name] += g
                    pieces = {"policy_reward": aux["reward"], "loss_path": loss_path,
                              "total_loss": total}
                    pieces.update({f"sup_{k}": aux["sup"][k] for k in _SUP_KEYS})
                    pieces.update({f"det_{k}": aux["det"][k] for k in _SUP_KEYS})
                    for k, v in pieces.items():
                        m[k] = m.get(k, 0.0) + v.detach().double().sum()
        return grads if with_grads else None, self._finalize_metrics(m, b), path_state

    def _finalize_metrics(self, m, b):
        # the supervisor's cardinality and class errors overwrite the detector's
        out = self.rename({k: m[f"det_{k}"] / b for k in _SUP_KEYS}, "detector")
        out.update(self.rename({k: m[f"sup_{k}"] / b for k in _SUP_KEYS}, "supervisor"))
        if self.with_policy:
            out["loss_supervisor_path"] = m["loss_path"] / b
            out["policy_reward"] = m["policy_reward"] / b
        out["total_loss"] = m["total_loss"] / b
        return out

    def grads_and_metrics(self, batch, gen, path_state=None, train=True, frame_index=None):
        """Gradients of the meta-train loss summed over the batch's episodes,
        the mean metrics, and the new path state (<- `grads_and_metrics`).

        batch: numpy arrays frames (b, 5, H, W, 3), actions (b, 5), labels
        (b, 5, M), boxes (b, 5, M, 4) cxcywh, valid (b, 5, M), episode_uid
        (b,). `gen` is a CPU torch.Generator: it draws each episode's frame
        index in episode order (unless `frame_index`, one per episode, is
        given) and, with `train`, each microbatch's dropout streams. Returns
        ({"detector": {name: grad}, "fusion": {name: grad}}, {metric: 0-d
        float64 tensor on the task's device}, path state); the metrics stay
        on the device, so a loop can sum them there and fetch them once.
        Deformable DETR is not meta-trained: the inner gradient's graph needs
        a second-order backward of its attention (ops/ms_deform_attn.py),
        which the port does not have."""
        if isinstance(self.detector, DeformableDETR):
            raise NotImplementedError(
                "meta-training Deformable DETR (MODEL.BACKBONE "
                f"{self.config.MODEL.BACKBONE!r}) needs the second-order backward of the "
                "multi-scale deformable attention, which the port does not have; it serves "
                "(next_action, predict) only")
        return self._run(batch, gen, path_state, train, frame_index, with_grads=True)

    def eval_metrics(self, batch, gen, path_state=None, frame_index=None):
        """Test-epoch losses: dropout off, no outer gradient, path storage
        still updated (<- `eval_metrics`). Returns (metrics, path state)."""
        _, metrics, path_state = self._run(batch, gen, path_state, False, frame_index,
                                           with_grads=False)
        return metrics, path_state


class InteractronTask(InteractronRandomTask):
    """Full interactron: learned policy + learned loss."""

    with_policy = True

    @torch.no_grad()
    def next_action(self, episodes):
        """Argmax of the fusion's action logits at token s-1 for each of E
        episodes of s frames (1 <= s <= 4; episodes["frames"] (E, s, H, W,
        3)), in one batched pass with the shared weights: (E,) int64. On
        the card both passes replay CUDA graphs once their shapes have been
        seen twice (`TaskModel.detr_apply`)."""
        e, s = len(episodes["frames"]), episodes["frames"].shape[1]
        with profiling.span("serve.next_action", episodes=e, s=s):
            frames = self.frames(episodes)
            with profiling.span("next_action.detect"):
                out = self.detr_apply(None, frames.flatten(0, 1))
            with profiling.span("next_action.fusion"):
                fus = self.fusion_apply(out, episodes=e)
                return torch.argmax(fus["actions"][:, s - 1], dim=-1)
