"""The reference Interactron task in fp32: a frozen copy of the port's
tasks/base.py and tasks/interactron.py with one formulation each (dense
attention, grouped convs, no scopes, no checkpointing).

  adapt:   g = grad_a ||fusion.loss(detr(a, frames))||, fast = a - clip(lr*g, +-0.01)
  predict: adapt, then detect frame 0 with the fast weights
  next_action: argmax of the fusion's action logits at token s-1
  train:   per microbatch of INNER_BATCH episodes, the inner gradient with
           its graph, the supervisor pass on all frames with a - clip(lr*g),
           the detector pass on each episode's frame ridx with g stopped, the
           path storage and the policy cross entropy; gradients summed.

A microbatch runs as one batched pass over its E episodes, each with its
own fast weights, so the dropout masks (keyed by the row in the batch) are
the port's.

Everything computes in fp32 but the fast weights' values: the configuration
states the inner step's precision (MODEL.INNER_DTYPE, else MODEL.DTYPE
unless fp32), and its fast weights a - clip(lr*g) are values of that type
(the port and the JAX package take the step in it). With random weights
the step is often smaller than half a bf16 ulp of the weight it moves, so
the rounding is part of what the step computes; the reference takes the
step in fp32 and rounds its result once to that type (the gradient passes
the rounding unchanged).
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from portbench.reference import constants as C
from portbench.reference.criterion import set_criterion
from portbench.reference.detr import DETR
from portbench.reference.fusion import build_fusion
from portbench.reference.meta import clipped_sgd_step, learned_loss_value, merge_inner, split_inner
from portbench.reference.path_storage import init_path_state, update_and_label

_SUP_KEYS = ["loss_ce", "loss_bbox", "loss_giou", "cardinality_error", "class_error"]


def sub_generator(gen):
    """A CPU generator seeded from `gen`: one dropout stream per pass."""
    return torch.Generator().manual_seed(int(torch.randint(0, 2**62, (), generator=gen)))


def _weighted(losses):
    return losses["loss_ce"] + 5.0 * losses["loss_giou"] + 2.0 * losses["loss_bbox"]


class ReferenceTask(nn.Module):
    """`interactron` (learned policy + learned loss) and `interactron_random`
    (learned loss, FusionXAttn, no policy) in fp32."""

    def __init__(self, config, device):
        super().__init__()
        self.device = torch.device(device)
        m = config.MODEL
        self.detector = DETR(
            num_classes=m.NUM_CLASSES,
            num_queries=int(m.get("NUM_QUERIES", C.NUM_QUERIES)),
            d_model=int(m.get("D_MODEL", 256)),
            num_heads=int(m.get("DETR_NUM_HEADS", 8)),
            num_encoder_layers=int(m.get("NUM_ENCODER_LAYERS", 6)),
            num_decoder_layers=int(m.get("NUM_DECODER_LAYERS", 6)),
            ff_dim=int(m.get("DETR_FF_DIM", 2048)),
            dropout_rate=float(m.get("DETR_DROPOUT", 0.1)),
            backbone=m.get("BACKBONE", "resnet50"),
            image_size=int(m.get("TEST_RESOLUTION", C.IMG_SIZE)),
        )
        self.fusion = build_fusion(config)
        self.num_classes = m.NUM_CLASSES
        self.costs = dict(cost_class=float(m.get("SET_COST_CLASS", 1.0)),
                          cost_bbox=float(m.get("SET_COST_BBOX", 5.0)),
                          cost_giou=float(m.get("SET_COST_GIOU", 2.0)))
        self.adaptive_lr = float(m.get("ADAPTIVE_LR", 1e-3))
        self.inner_batch = int(config.TRAINER.get("INNER_BATCH", 1))
        # `interactron_random` has no policy: no path storage, no policy loss
        self.with_policy = m.TYPE == "interactron"
        inner = m.get("INNER_DTYPE") or m.get("DTYPE")
        self.fast_dtype = torch.bfloat16 if inner == "bfloat16" else None
        # a list: each microbatch's inner gradient, and the one with the
        # weights rounded to bf16, are kept in it
        self.kept_g = None
        self.requires_grad_(False)
        self.eval()
        self.to(self.device)

    def modules_by_group(self):
        return {"detector": self.detector, "fusion": self.fusion}

    # ------------------------------------------------------------ module fns

    def frozen_prefix(self, images):
        return self.detector(images, stage="frozen_prefix")

    def detr_apply(self, det_params, images, stage="all", gen=None):
        if det_params is None:
            return self.detector(images, stage=stage, gen=gen)
        return functional_call(self.detector, det_params, (images,), {"stage": stage, "gen": gen})

    def fusion_apply(self, detr_out, fus_params=None, gen=None, episodes=1):
        keys = ("embedded_memory_features", "box_features", "pred_logits", "pred_boxes")
        x = {k: detr_out[k].reshape(episodes, -1, *detr_out[k].shape[1:]) for k in keys}
        if fus_params is None:
            return self.fusion(x, gen=gen)
        return functional_call(self.fusion, fus_params, (x,), {"gen": gen})

    def criterion(self, outputs, targets, **kw):
        return set_criterion(outputs, targets, num_classes=self.num_classes, **self.costs, **kw)

    def frames(self, episodes):
        return torch.as_tensor(episodes["frames"], dtype=torch.float32, device=self.device)

    def _step(self, params, grads):
        """The inner step a - clip(lr*g, +-0.01), its values those of the
        configuration's inner dtype."""
        fast = clipped_sgd_step(params, grads, self.adaptive_lr)
        if self.fast_dtype is None:
            return fast
        return {k: v.to(self.fast_dtype).to(v.dtype) for k, v in fast.items()}

    @staticmethod
    def _per_episode(adapted, e):
        return {k: v.detach().expand(e, *v.shape).requires_grad_(True)
                for k, v in adapted.items()}

    # ------------------------------------------------------------ served calls

    @torch.no_grad()
    def action_logits(self, episodes):
        """(E, 4) action logits at token s-1 of E episodes of s frames."""
        frames = self.frames(episodes)
        e, s = frames.shape[:2]
        fus = self.fusion_apply(self.detr_apply(None, frames.flatten(0, 1)), episodes=e)
        return fus["actions"][:, s - 1]

    def inner_grad(self, episodes):
        """g of E episodes (each its own, (E, ...)) and the frozen prefix."""
        frames = self.frames(episodes)
        e = frames.shape[0]
        with torch.no_grad():
            prefix = self.frozen_prefix(frames.flatten(0, 1))
        adapted_p, static_p = split_inner(dict(self.detector.named_parameters()))
        leaves = self._per_episode(adapted_p, e)
        with torch.enable_grad():
            out = self.detr_apply(merge_inner(leaves, static_p), prefix, stage="from_prefix")
            loss = learned_loss_value(self.fusion_apply(out, episodes=e))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, grads)), prefix

    def fast_weights(self, g):
        """The fast weights of the step by g: the adapted leaves (E, ...),
        the q/k/v in-projections shared, in the inner dtype's values."""
        adapted_p, static_p = split_inner(dict(self.detector.named_parameters()))
        static = static_p if self.fast_dtype is None else {
            k: v.to(self.fast_dtype).to(v.dtype) for k, v in static_p.items()}
        return merge_inner(self._step(adapted_p, g), static)

    @torch.no_grad()
    def detect(self, fast, prefix, e):
        """The frame-0 detect of E episodes with their fast weights."""
        out0 = self.detr_apply(fast, prefix.unflatten(0, (e, -1))[:, 0], stage="from_prefix")
        return {"pred_logits": out0["pred_logits"][:, None],
                "pred_boxes": out0["pred_boxes"][:, None]}

    def predict(self, episodes):
        g, prefix = self.inner_grad(episodes)
        return self.detect(self.fast_weights(g), prefix, len(episodes["frames"]))

    # ------------------------------------------------------------ train step

    def _mb_fwd(self, params, eps, ridx, gens):
        det_p, fus_p = params["detector"], params["fusion"]
        e = eps["frames"].shape[0]
        adapted_p, static_p = split_inner(det_p)
        adapted_base = self._per_episode(adapted_p, e)
        with torch.no_grad():
            prefix = self.frozen_prefix(eps["frames"].flatten(0, 1))
        unit = None if self.kept_g is None else self._rounded_inner_g(params, prefix, e, gens)
        out = self.detr_apply(merge_inner(adapted_base, static_p), prefix, stage="from_prefix",
                              gen=gens[0])
        fus_out = self.fusion_apply(out, fus_p, gen=gens[1], episodes=e)
        grads = torch.autograd.grad(learned_loss_value(fus_out), list(adapted_base.values()),
                                    create_graph=True)
        g = dict(zip(adapted_base, grads))
        if self.kept_g is not None:
            self.kept_g.append({"g": {k: v.detach().cpu() for k, v in g.items()}, "unit": unit})
        fast2 = merge_inner(self._step(adapted_base, g), static_p)
        post = self.detr_apply(fast2, prefix, stage="from_prefix", gen=gens[2])
        targets = {k: eps[k].flatten(0, 1) for k in ("labels", "boxes", "valid")}
        sup = self.criterion({k: post[k] for k in ("pred_logits", "pred_boxes")}, targets,
                             per_frame=True, episodes=e)
        pf = sup.pop("_per_frame")
        nb0 = pf["num_boxes"][:, 0].clamp(min=1.0)
        reward = (pf["ce_num"][:, 0] / pf["ce_den"][:, 0]
                  + 5.0 * (pf["giou_sum"][:, 0] / nb0)
                  + 2.0 * (pf["bbox_sum"][:, 0] / nb0)).detach()
        g_stopped = {k: v.detach() for k, v in g.items()}
        fast1 = merge_inner(self._step(adapted_p, g_stopped), static_p)
        rows = (torch.arange(e) * C.NUM_FRAMES + torch.as_tensor(ridx)).to(prefix.device)
        det_out = self.detr_apply(fast1, prefix[rows], stage="from_prefix", gen=gens[3])
        det = self.criterion({k: det_out[k] for k in ("pred_logits", "pred_boxes")},
                             {k: v[rows] for k, v in targets.items()}, episodes=e)
        return _weighted(sup) + _weighted(det), fus_out["actions"], reward

    def _rounded_inner_g(self, params, prefix, e, gens):
        """The inner gradient of a microbatch with every weight rounded to
        bf16 and the arithmetic in fp32, on copies of the passes' dropout
        streams: the unit in which the train cells' g_err is read, since
        how far a rounding moves g depends on the seed's weights."""
        rounded = {grp: {k: v.detach().to(torch.bfloat16).to(v.dtype) for k, v in d.items()}
                   for grp, d in params.items()}
        adapted, static = split_inner(rounded["detector"])
        leaves = self._per_episode(adapted, e)
        copy = lambda g: None if g is None else torch.Generator().set_state(g.get_state())
        with torch.enable_grad():
            out = self.detr_apply(merge_inner(leaves, static), prefix, stage="from_prefix",
                                  gen=copy(gens[0]))
            fus = self.fusion_apply(out, rounded["fusion"], gen=copy(gens[1]), episodes=e)
            grads = torch.autograd.grad(learned_loss_value(fus), list(leaves.values()))
        return {k: v.cpu() for k, v in zip(leaves, grads)}

    def grads_and_loss(self, batch, gen, path_state):
        """Gradients of the meta-train loss summed over the batch's episodes
        ({group: {name: grad}}), the mean total loss (a float) and the new
        path state; dropout on, the frame indices and dropout streams drawn
        from the CPU generator `gen` in the port's order."""
        b = batch["frames"].shape[0]
        params = {grp: {n: p.detach().requires_grad_(True) for n, p in mod.named_parameters()}
                  for grp, mod in self.modules_by_group().items()}
        names = [(grp, n) for grp, d in params.items() for n in d]
        leaves = [params[grp][n] for grp, n in names]
        grads = {grp: {n: torch.zeros_like(p) for n, p in d.items()} for grp, d in params.items()}
        num_micro = max(1, b // max(1, self.inner_batch))
        size = b // num_micro
        total = 0.0
        for i in range(num_micro):
            mb = slice(i * size, (i + 1) * size)
            eps = {k: torch.as_tensor(batch[k][mb], device=self.device)
                   for k in ("frames", "labels", "boxes", "valid", "actions", "episode_uid")}
            eps["frames"] = eps["frames"].float()
            ridx = [int(torch.randint(0, C.NUM_FRAMES, (), generator=gen))
                    for _ in range(mb.start, mb.stop)]
            gens = [sub_generator(gen) for _ in range(4)]
            with torch.enable_grad():
                main, logits, reward = self._mb_fwd(params, eps, ridx, gens)
                mb_total = main.sum()
                if self.with_policy:
                    path_state, best = update_and_label(path_state, eps["episode_uid"],
                                                        eps["actions"][:, :C.NUM_ACTIONS], reward)
                    onehot = F.one_hot(best, C.NUM_ACTIONS).to(logits.dtype)
                    loss_path = -(onehot * F.log_softmax(logits, -1)).sum((1, 2)) / C.NUM_ACTIONS
                    mb_total = mb_total + loss_path.sum()
                got = torch.autograd.grad(mb_total, leaves, allow_unused=True)
            for (grp, name), g in zip(names, got):
                if g is not None:
                    grads[grp][name] += g
            total += float(mb_total.detach())
        return grads, total / b, path_state

    def init_path_state(self, rows):
        return init_path_state(rows, self.device)
