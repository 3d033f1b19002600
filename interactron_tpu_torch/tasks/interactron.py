"""Adaptive prediction, the policy step and the second-order meta-train step
of `interactron_random` and full `interactron` (counterpart of
interactron_tpu/tasks/interactron.py).

Per episode of the train step (`_episode_fwd`, <- `_episode_fwd:74-185`):

  supervisor (second-order) path, detector params stopped:
      g     = grad_a ||fusion.loss(detr(a, frames))||, a = cast(sg(det))
      fast2 = a - clip(lr*g, +-0.01)
      L_sup = criterion(detr(fast2, frames), all 5 frames' targets)
      -> d L_sup / d fusion flows through g (create_graph=True)
  detector (first-order) path, g stopped:
      fast1 = cast(det) - clip(lr*sg(g), +-0.01)
      L_det = criterion(detr(fast1, frame[ridx]), targets[ridx]), ridx ~ U{0..4}
  policy (interactron only): the frame-0 loss of the supervisor pass is the
      path reward; the best-path labels are read after the storage update,
      and their cross entropy with the action logits is added to the loss.

The DETR q/k/v in-projections are not adapted; their casts are not stopped,
so outer gradients reach them through every pass. The inner pass runs under
`flash_disabled()`, so its attentions take the second-order kernels.
Episodes run one at a time with a backward each; gradients are sums over
episodes, as in the reference.
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
from interactron_tpu_torch.ops.attention import flash_disabled
from interactron_tpu_torch.tasks.base import TaskModel
from interactron_tpu_torch.utils import constants as C
from interactron_tpu_torch.utils.device_path_storage import init_path_state, update_and_label

_SUP_KEYS = ["loss_ce", "loss_bbox", "loss_giou", "cardinality_error", "class_error"]


def _weighted(losses):
    """ce + 5*giou + 2*bbox."""
    return losses["loss_ce"] + 5.0 * losses["loss_giou"] + 2.0 * losses["loss_bbox"]


def _sub_generator(gen):
    """A CPU generator seeded from `gen`: one dropout stream per pass."""
    return torch.Generator().manual_seed(int(torch.randint(0, 2**62, (), generator=gen)))


class InteractronRandomTask(TaskModel):
    needs_fusion = True
    with_policy = False
    # rows of a transient path state when the caller threads none
    default_path_rows = 4096

    def init_path_state(self, num_episodes):
        return init_path_state(num_episodes, self.device)

    def _cast(self, t):
        return t if self.inner_dtype is None else t.to(self.inner_dtype)

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
        static_c = {k: self._cast(v) for k, v in static_p.items()}
        leaves = {k: self._cast(v).detach().requires_grad_(True) for k, v in adapted_p.items()}
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

    # ------------------------------------------------------------ train step

    def trainable_leaves(self):
        """{"detector": {name: leaf}, "fusion": {name: leaf}}: leaves that
        share the parameters' storage and require grad."""
        return {grp: {n: p.detach().requires_grad_(True) for n, p in mod.named_parameters()}
                for grp, mod in (("detector", self.detector), ("fusion", self.fusion))}

    def _episode(self, batch, i):
        dev = self.device
        ep = {k: torch.as_tensor(batch[k][i], device=dev)
              for k in ("frames", "labels", "boxes", "valid", "actions")}
        ep["frames"] = ep["frames"].float()
        ep["episode_uid"] = torch.as_tensor(batch["episode_uid"][i:i + 1], device=dev)
        return ep

    def _episode_fwd(self, params, ep, ridx, gens, second_order):
        """(main loss, action logits (4, 4), aux) of one episode. `gens` holds
        the dropout generators of the inner detector, fusion, supervisor and
        detector passes (all None without dropout). With `second_order` the
        inner gradient keeps its graph, so the supervisor loss reaches the
        fusion through g."""
        det_p, fus_p = params["detector"], params["fusion"]
        adapted_p, static_p = split_inner(det_p)
        adapted_base = {k: self._cast(v.detach()).requires_grad_(True)
                        for k, v in adapted_p.items()}
        static_c = {k: self._cast(v) for k, v in static_p.items()}  # not stopped
        with torch.no_grad():
            prefix = self.frozen_prefix(ep["frames"])

        with torch.enable_grad():
            with flash_disabled() if second_order else nullcontext():
                out = self.detr_apply(merge_inner(adapted_base, static_c), prefix,
                                      stage="from_prefix", gen=gens[0])
                fus_out = self.fusion_apply(out, fus_p, gen=gens[1])
            grads = torch.autograd.grad(learned_loss_value(fus_out), list(adapted_base.values()),
                                        create_graph=second_order)
        g = dict(zip(adapted_base, grads))

        with torch.set_grad_enabled(second_order):
            # supervisor (second-order) path on all frames
            fast2 = merge_inner(clipped_sgd_step(adapted_base, g, self.adaptive_lr), static_c)
            post = self.detr_apply(fast2, prefix, stage="from_prefix", gen=gens[2])
            targets = {k: ep[k] for k in ("labels", "boxes", "valid")}
            sup = self.criterion({k: post[k] for k in ("pred_logits", "pred_boxes")}, targets,
                                 per_frame=True)
            pf = sup.pop("_per_frame")
            # frame-0 ground-truth loss of the adapted detector: the policy reward
            nb0 = pf["num_boxes"][0].clamp(min=1.0)
            reward = (pf["ce_num"][0] / pf["ce_den"][0] + 5.0 * (pf["giou_sum"][0] / nb0)
                      + 2.0 * (pf["bbox_sum"][0] / nb0)).detach()

            # detector (first-order) path on frame ridx
            g_stopped = {k: v.detach() for k, v in g.items()}
            fast1 = merge_inner(clipped_sgd_step(adapted_p, g_stopped, self.adaptive_lr,
                                                 dtype=self.inner_dtype), static_c)
            det_out = self.detr_apply(fast1, prefix[ridx:ridx + 1], stage="from_prefix",
                                      gen=gens[3])
            det = self.criterion({k: det_out[k] for k in ("pred_logits", "pred_boxes")},
                                 {k: v[ridx:ridx + 1] for k, v in targets.items()})
        main = _weighted(sup) + _weighted(det)
        aux = {"reward": reward, "sup": {k: v.detach() for k, v in sup.items()},
               "det": {k: v.detach() for k, v in det.items()}}
        return main, fus_out["actions"][0], aux

    def _policy_piece(self, logits, aux, ep, path_state):
        """(loss_path, new path state): update the path storage with the
        episode's reward, then the cross entropy of the action logits with
        the best-path labels read after the update (<- `_policy_piece`)."""
        if not self.with_policy:
            return torch.zeros((), device=logits.device), path_state
        path_state, best = update_and_label(path_state, ep["episode_uid"],
                                            ep["actions"][None, :C.NUM_ACTIONS],
                                            aux["reward"][None])
        onehot = F.one_hot(best[0], C.NUM_ACTIONS).to(logits.dtype)
        loss_path = -(onehot * F.log_softmax(logits, -1)).sum() / C.NUM_ACTIONS
        return loss_path, path_state

    def _run(self, batch, gen, path_state, train, frame_index, with_grads):
        b = batch["frames"].shape[0]
        params = (self.trainable_leaves() if with_grads else
                  {grp: dict(mod.named_parameters())
                   for grp, mod in (("detector", self.detector), ("fusion", self.fusion))})
        names = [(grp, n) for grp, d in params.items() for n in d]
        leaves = [params[grp][n] for grp, n in names]
        if path_state is None and self.with_policy:
            path_state = self.init_path_state(self.default_path_rows)
        m = {}
        grads = {grp: {n: torch.zeros_like(p) for n, p in d.items()} for grp, d in params.items()}
        for i in range(b):
            ep = self._episode(batch, i)
            ridx = (int(frame_index[i]) if frame_index is not None
                    else int(torch.randint(0, C.NUM_FRAMES, (), generator=gen)))
            gens = [_sub_generator(gen) if train else None for _ in range(4)]
            main, logits, aux = self._episode_fwd(params, ep, ridx, gens, with_grads)
            with torch.set_grad_enabled(with_grads):
                loss_path, path_state = self._policy_piece(logits, aux, ep, path_state)
                total = main + loss_path
            if with_grads:
                # summed by hand: accumulating in .grad across the episodes'
                # backward calls counted the second episode's action-token
                # gradient twice (torch 2.13, CPU); the sum is held against
                # JAX in tests/test_torch_port_train.py
                got = torch.autograd.grad(total, leaves, allow_unused=True)
                for (grp, name), g in zip(names, got):
                    if g is not None:
                        grads[grp][name] += g
            pieces = {"policy_reward": aux["reward"], "loss_path": loss_path, "total_loss": total}
            pieces.update({f"sup_{k}": aux["sup"][k] for k in _SUP_KEYS})
            pieces.update({f"det_{k}": aux["det"][k] for k in _SUP_KEYS})
            for k, v in pieces.items():
                m[k] = m.get(k, 0.0) + v.detach().double()
        return grads if with_grads else None, self._finalize_metrics(m, b), path_state

    def _finalize_metrics(self, m, b):
        out = {}
        for k in _SUP_KEYS:
            out[k.replace("loss", "loss_detector") if "loss" in k else k] = m[f"det_{k}"] / b
        for k in _SUP_KEYS:
            out[k.replace("loss", "loss_supervisor") if "loss" in k else k] = m[f"sup_{k}"] / b
        if self.with_policy:
            out["loss_supervisor_path"] = m["loss_path"] / b
            out["policy_reward"] = m["policy_reward"] / b
        out["total_loss"] = m["total_loss"] / b
        return {k: float(v) for k, v in out.items()}

    def grads_and_metrics(self, batch, gen, path_state=None, train=True, frame_index=None):
        """Gradients of the meta-train loss summed over the batch's episodes,
        the mean metrics, and the new path state (<- `grads_and_metrics`).

        batch: numpy arrays frames (b, 5, H, W, 3), actions (b, 5), labels
        (b, 5, M), boxes (b, 5, M, 4) cxcywh, valid (b, 5, M), episode_uid
        (b,). `gen` is a CPU torch.Generator: it draws each episode's frame
        index (unless `frame_index`, one per episode, is given) and, with
        `train`, its dropout streams. Returns ({"detector": {name: grad},
        "fusion": {name: grad}}, {metric: float}, path state)."""
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
    def next_action(self, episode):
        """Argmax of the fusion's action logits at token s-1, for an episode
        of s frames (1 <= s <= 4)."""
        frames = self.frames(episode)[0]
        s = frames.shape[0]
        fus = self.fusion_apply(self.detr_apply(None, frames))
        return torch.argmax(fus["actions"][0, s - 1], dim=-1)
