"""The optimizer step of meta-training (counterpart of
interactron_tpu/engine/trainer.py: `global_norm_clip`, the body of
`Trainer.train_step`, `_lr_scale` and `_advance_tokens`).

Two Adams, detector at DETECTOR_LR and fusion ("supervisor") at
SUPERVISOR_LR (1e-5 / 1e-4 whatever the config for interactron_random, as
the reference hardcodes), with optax's defaults as the JAX trainer builds
them: betas (0.9, 0.999), eps 1e-8 (the config's BETA1/BETA2 are never
read). One global-norm clip over all gradients jointly, then the
supervisor's optional warmup + cosine LR scale keyed to seen frames.
Datasets, epochs, checkpoints and evaluation are not ported yet: a step
takes a batch of in-memory episodes.
"""

import math

import torch


def global_norm_clip(grads, max_norm):
    """grads {group: {name: tensor}} scaled by min(1, max_norm / (norm +
    1e-6)), and the fp32 global norm before clipping."""
    leaves = [g for grp in grads.values() for g in grp.values()]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {grp: {n: g * scale for n, g in d.items()} for grp, d in grads.items()}, norm


class Trainer:
    def __init__(self, task, config, path_rows=None):
        t = config.TRAINER
        self.task = task
        self.type = t.TYPE
        if self.type not in ("interactron", "interactron_random"):
            raise NotImplementedError(f"trainer type {self.type!r} is not ported")
        if self.type == "interactron_random":
            self.detector_lr, self.supervisor_lr = 1e-5, 1e-4
        else:
            self.detector_lr = float(t.get("DETECTOR_LR", 1e-5))
            self.supervisor_lr = float(t.get("SUPERVISOR_LR", 1e-4))
        self.grad_clip = float(t.get("GRAD_NORM_CLIP", 1.0))
        self.lr_decay = bool(t.get("LR_DECAY", False))
        self.warmup_tokens = float(t.get("WARMUP_TOKENS", 0) or 0)
        self.final_tokens = float(t.get("FINAL_TOKENS", 0) or 0)
        self.tokens = 0
        adam = lambda mod, lr: torch.optim.Adam(mod.parameters(), lr=lr, betas=(0.9, 0.999),
                                                eps=1e-8)
        self.opts = {"detector": adam(task.detector, self.detector_lr),
                     "fusion": adam(task.fusion, self.supervisor_lr)}
        self.path_state = task.init_path_state(path_rows or task.default_path_rows)

    def _lr_scale(self):
        """Supervisor LR scale; the first step always runs at 1.0, as the
        reference re-sets the LR only after each step."""
        if not self.lr_decay or self.tokens == 0:
            return 1.0
        if self.tokens < self.warmup_tokens:
            return float(self.tokens) / float(max(1, self.warmup_tokens))
        progress = float(self.tokens - self.warmup_tokens) / float(
            max(1, self.final_tokens - self.warmup_tokens))
        return max(0.1, 0.5 * (1.0 + math.cos(math.pi * progress)))

    def _advance_tokens(self, rows, seq_len):
        """The interactron trainers count frames."""
        self.tokens += rows * seq_len

    def apply_grads(self, grads, sup_lr_scale=1.0):
        """Clip jointly, then one Adam step per group. Returns the global norm."""
        grads, gnorm = global_norm_clip(grads, self.grad_clip)
        self.opts["fusion"].param_groups[0]["lr"] = self.supervisor_lr * sup_lr_scale
        for grp, mod in (("detector", self.task.detector), ("fusion", self.task.fusion)):
            for name, p in mod.named_parameters():
                p.grad = grads[grp][name]
            self.opts[grp].step()
            self.opts[grp].zero_grad(set_to_none=True)
        return gnorm

    def train_step(self, batch, gen, frame_index=None):
        """One step on a batch of episodes (see InteractronTask.grads_and_metrics):
        returns the metrics with the pre-clip `grad_norm`."""
        scale = self._lr_scale()
        grads, metrics, self.path_state = self.task.grads_and_metrics(
            batch, gen, self.path_state, train=True, frame_index=frame_index)
        metrics["grad_norm"] = float(self.apply_grads(grads, scale))
        self._advance_tokens(batch["frames"].shape[0], batch["frames"].shape[1])
        return metrics
