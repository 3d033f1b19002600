"""The reference optimizer step: the port's engine/trainer.py for the
`interactron` and `interactron_random` trainer types. One global-norm clip over every gradient,
then an Adam per group (detector at DETECTOR_LR, fusion at SUPERVISOR_LR;
betas (0.9, 0.999), eps 1e-8, optax's defaults as the JAX trainer builds
them), the LR scale at 1.0 (LR_DECAY off)."""

import torch


def global_norm_clip(grads, max_norm):
    leaves = [g for grp in grads.values() for g in grp.values()]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {grp: {n: g * scale for n, g in d.items()} for grp, d in grads.items()}


class ReferenceTrainer:
    def __init__(self, task, trainer_config, path_rows):
        t = trainer_config
        self.task = task
        self.clip = float(t.get("GRAD_NORM_CLIP", 1.0))
        lrs = {"detector": float(t.get("DETECTOR_LR", 1e-5)),
               "fusion": float(t.get("SUPERVISOR_LR", 1e-4))}
        if t.TYPE == "interactron_random":  # the reference hardcodes them
            lrs = {"detector": 1e-5, "fusion": 1e-4}
        self.opts = {grp: torch.optim.Adam(list(mod.parameters()), lr=lrs[grp],
                                           betas=(0.9, 0.999), eps=1e-8, foreach=False)
                     for grp, mod in task.modules_by_group().items()}
        self.path_state = task.init_path_state(path_rows)

    def step(self, batch, gen):
        """One step; returns the batch's mean total loss."""
        grads, loss, self.path_state = self.task.grads_and_loss(batch, gen, self.path_state)
        grads = global_norm_clip(grads, self.clip)
        for grp, mod in self.task.modules_by_group().items():
            for name, p in mod.named_parameters():
                p.grad = grads[grp][name]
            self.opts[grp].step()
            self.opts[grp].zero_grad(set_to_none=True)
        return loss
