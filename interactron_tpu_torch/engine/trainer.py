"""Training (counterpart of interactron_tpu/engine/trainer.py): the
optimizer step (`global_norm_clip`, `train_step`, `_lr_scale`,
`_advance_tokens`) and the epoch loop over episodes on disk (`train`).

By TRAINER.TYPE, with optax's defaults as the JAX trainer builds its Adams:
betas (0.9, 0.999), eps 1e-8 (the config's BETA1/BETA2 are never read):
  * interactron, interactron_random: two Adams, detector at DETECTOR_LR and
    fusion ("supervisor") at SUPERVISOR_LR (1e-5 / 1e-4 whatever the
    config for interactron_random, as the reference hardcodes); the LR
    scale below applies to the supervisor, and tokens count frames;
  * direct_supervision: one Adam, "all", over the detector and the fusion
    (where the task has one) at LEARNING_RATE (else LR, else 1e-4); the LR
    scale applies to it, and tokens count episodes.
One global-norm clip over all gradients jointly, then the optional warmup
+ cosine LR scale keyed to seen tokens.

`train` runs epoch 0 as a test epoch and an evaluation, then per epoch a
shuffled train epoch, a test epoch and an evaluation, logs the epoch means
to `metrics.jsonl`, keeps the uniform weight average of the last
SAVE_WINDOW epochs, writes `last_state.ckpt` (the whole train state, for
`resume_from`) every epoch and `detector.ckpt` (the averaged weights) at
the end. The task runs a batch in microbatches of TRAINER.INNER_BATCH
episodes (tasks/base.py::microbatches); tokens, the LR scale and the
metrics (means over the batch's episodes) do not depend on the split. The
loop's random stream is its own CPU generator seeded 1234: it cannot match
JAX's threefry keys.

Over several torch.distributed ranks (parallel/mesh.py; BATCH_SIZE must
divide among them) each rank loads its slice of every batch and the train
step is `data_parallel_grads`: gradients summed, metrics averaged, path
state merged, so every rank holds the same weights. Tokens advance by the
global batch. A test batch that divides is sharded the same way; a tail
that does not is computed whole on every rank. Rank r > 0 logs to its own
directory (suffix `-p{r}`), and only rank 0 writes checkpoints.
"""

import math
import os
import time
from datetime import datetime

import torch

from interactron_tpu_torch.data.episode_dataset import EpisodeDataset, EpisodeLoader
from interactron_tpu_torch.parallel.mesh import (
    data_parallel_grads,
    mean_metrics,
    merge_path_state,
    rank,
    world_size,
)
from interactron_tpu_torch.utils.checkpoint import (
    RunningAverage,
    load_state,
    save_checkpoint,
    save_state,
)
from interactron_tpu_torch.utils.logging import MetricLogger


def global_norm_clip(grads, max_norm):
    """grads {group: {name: tensor}} scaled by min(1, max_norm / (norm +
    1e-6)), and the fp32 global norm before clipping."""
    leaves = [g for grp in grads.values() for g in grp.values()]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {grp: {n: g * scale for n, g in d.items()} for grp, d in grads.items()}, norm


class Trainer:
    """`task` trains in place: the loop starts from the weights it holds.
    `evaluator` (engine/evaluator.py), when given, runs after every test
    epoch. `path_rows` sizes the path state of `train_step` calls made
    outside `train`, which sizes its own from the datasets."""

    def __init__(self, task, config, evaluator=None, path_rows=None):
        t = config.TRAINER
        self.task = task
        self.config = config
        self.evaluator = evaluator
        self.type = t.TYPE
        if self.type not in ("interactron", "interactron_random", "direct_supervision"):
            raise ValueError(f"unknown trainer type {self.type!r}")
        if self.type == "interactron_random":
            self.detector_lr, self.supervisor_lr = 1e-5, 1e-4
        else:
            self.detector_lr = float(t.get("DETECTOR_LR", 1e-5))
            self.supervisor_lr = float(t.get("SUPERVISOR_LR", 1e-4))
        self.single_optimizer = self.type == "direct_supervision"
        self.learning_rate = float(t.get("LEARNING_RATE", t.get("LR", 1e-4)))
        self.grad_clip = float(t.get("GRAD_NORM_CLIP", 1.0))
        self.lr_decay = bool(t.get("LR_DECAY", False))
        self.warmup_tokens = float(t.get("WARMUP_TOKENS", 0) or 0)
        self.final_tokens = float(t.get("FINAL_TOKENS", 0) or 0)
        self.tokens = 0
        self.batch_size = int(t.BATCH_SIZE)
        self.max_epochs = int(t.MAX_EPOCHS)
        self.save_window = int(t.get("SAVE_WINDOW", 0) or 0)
        self.num_workers = int(t.get("NUM_WORKERS", 2))
        self.rank, self.world = rank(), world_size()
        if self.batch_size % self.world:
            raise ValueError(f"BATCH_SIZE {self.batch_size} does not divide among "
                             f"{self.world} ranks")
        self.grads_fn = data_parallel_grads(task) if self.world > 1 else task.grads_and_metrics
        self.avg = RunningAverage()
        adam = lambda mods, lr: torch.optim.Adam([p for m in mods for p in m.parameters()],
                                                 lr=lr, betas=(0.9, 0.999), eps=1e-8)
        groups = task.modules_by_group()
        # the optimizer whose LR the scale drives and the loop logs, and the
        # groups each optimizer steps
        if self.single_optimizer:
            self.opts = {"all": adam(groups.values(), self.learning_rate)}
            self.scaled, self.base_lr = "all", self.learning_rate
            self.opt_groups = {"all": list(groups)}
        else:
            self.opts = {"detector": adam([task.detector], self.detector_lr),
                         "fusion": adam([task.fusion], self.supervisor_lr)}
            self.scaled, self.base_lr = "fusion", self.supervisor_lr
            self.opt_groups = {"detector": ["detector"], "fusion": ["fusion"]}
        self.path_state = task.init_path_state(path_rows or task.default_path_rows)

    def _lr_scale(self):
        """Scale of the supervisor's LR (the single optimizer's under
        direct supervision); the first step always runs at 1.0, as the
        reference re-sets the LR only after each step."""
        if not self.lr_decay or self.tokens == 0:
            return 1.0
        if self.tokens < self.warmup_tokens:
            return float(self.tokens) / float(max(1, self.warmup_tokens))
        progress = float(self.tokens - self.warmup_tokens) / float(
            max(1, self.final_tokens - self.warmup_tokens))
        return max(0.1, 0.5 * (1.0 + math.cos(math.pi * progress)))

    def _advance_tokens(self, rows, seq_len):
        """The interactron trainers count frames, direct supervision episodes."""
        self.tokens += rows if self.single_optimizer else rows * seq_len

    def apply_grads(self, grads, lr_scale=1.0):
        """Clip jointly, then one step of each Adam. Returns the global norm."""
        grads, gnorm = global_norm_clip(grads, self.grad_clip)
        self.opts[self.scaled].param_groups[0]["lr"] = self.base_lr * lr_scale
        modules = self.task.modules_by_group()
        for opt_name, opt in self.opts.items():
            for grp in self.opt_groups[opt_name]:
                for name, p in modules[grp].named_parameters():
                    p.grad = grads[grp][name]
            opt.step()
            opt.zero_grad(set_to_none=True)
        return gnorm

    def train_step(self, batch, gen, frame_index=None):
        """One step on a batch of episodes (see InteractronTask.grads_and_metrics;
        over several ranks, this rank's slice of it): returns the metrics
        with the pre-clip `grad_norm`."""
        scale = self._lr_scale()
        grads, metrics, self.path_state = self.grads_fn(
            batch, gen, self.path_state, train=True, frame_index=frame_index)
        metrics["grad_norm"] = float(self.apply_grads(grads, scale))
        b, s = batch["frames"].shape[:2]
        self._advance_tokens(batch.get("_global_rows", b * self.world), s)
        return metrics

    # ------------------------------------------------------------- the loop

    def _prepare_run(self):
        """The run's output directory, logger and datasets, and a path state
        with a row for every train and test episode uid."""
        t = self.config.TRAINER
        suffix = f"-p{self.rank}" if self.rank else ""
        self.out_dir = os.path.join(t.OUTPUT_DIRECTORY,
                                    datetime.now().strftime("%m-%d-%Y:%H:%M:%S") + suffix)
        os.makedirs(self.out_dir, exist_ok=True)
        self.logger = MetricLogger(os.path.join(self.out_dir, "logs"))
        self.checkpoint_path = os.path.join(self.out_dir, "detector.ckpt")
        train_ds, test_ds = self.config.DATASET.TRAIN, self.config.DATASET.TEST
        size = dict(resolution=self.task.img_size, max_boxes=self.task.max_boxes)
        self.train_dataset = EpisodeDataset(train_ds.IMAGE_ROOT, train_ds.ANNOTATION_ROOT,
                                            train_ds.MODE, train_aug=True, **size)
        self.test_dataset = EpisodeDataset(test_ds.IMAGE_ROOT, test_ds.ANNOTATION_ROOT,
                                           test_ds.MODE, train_aug=False,
                                           uid_offset=len(self.train_dataset), **size)
        self.path_state = self.task.init_path_state(
            len(self.train_dataset) + len(self.test_dataset) + 1)

    def _run_epoch(self, split, gen, epoch):
        """One epoch of `split`; logs the metrics' means over its batches
        under "Train/" or "Test/" and returns the mean total loss. Train
        epochs shuffle with seed `epoch` and drop a short tail; test epochs
        keep it. The metrics are summed on the device and fetched once."""
        is_train = split == "train"
        loader = EpisodeLoader(self.train_dataset if is_train else self.test_dataset,
                               self.batch_size, shuffle=is_train, num_workers=self.num_workers,
                               seed=epoch, drop_last=is_train, process_index=self.rank,
                               process_count=self.world)
        acc, nb = {}, 0
        for batch in loader:
            if is_train:
                self.logger.add_value("Train/LR", self.base_lr * self._lr_scale())
                metrics = self.train_step(batch, gen)
            else:
                metrics, self.path_state = self.task.eval_metrics(batch, gen, self.path_state)
                if self.world > 1:
                    # a sharded batch's metrics are averaged; a tail every
                    # rank computed whole is the same on all of them
                    if len(batch["frames"]) * self.world == batch["_global_rows"]:
                        metrics = mean_metrics(metrics)
                    self.path_state = merge_path_state(self.path_state)
            acc = {k: acc.get(k, 0.0) + v for k, v in metrics.items()}
            nb += 1
        means = {k: float(v) / nb for k, v in acc.items()}
        for k, v in means.items():
            self.logger.add_value(f"{'Train' if is_train else 'Test'}/{k}", v)
        return means.get("total_loss", 0.0)

    def _run_evaluation(self, gen, epoch):
        """A test epoch, then the evaluator's (AP50, AP, TP, FP, FN)."""
        self._run_epoch("test", gen, epoch)
        if self.evaluator is not None:
            results = self.evaluator.evaluate(save_results=False, trained=True)
            for name, v in zip(("mAP_50", "mAP", "TP", "FP", "FN"), results):
                self.logger.add_value(f"Test/{name}", v)

    def train(self, max_epochs=None, resume_from=None):
        """Run epochs 1 .. max_epochs-1 after the epoch-0 evaluation (or
        continue after the epoch saved in `resume_from`, else
        TRAINER.RESUME_FROM, when that file exists). Returns the task, which
        holds the last epoch's weights; `detector.ckpt` holds the average."""
        max_epochs = max_epochs if max_epochs is not None else self.max_epochs
        self._prepare_run()
        start_epoch = 1
        resume_from = resume_from or self.config.TRAINER.get("RESUME_FROM")
        if resume_from and os.path.exists(resume_from):
            self.path_state, epoch, self.tokens = load_state(resume_from, self.task, self.opts)
            start_epoch = epoch + 1
            print(f"resumed from {resume_from} at epoch {start_epoch}")
        gen = torch.Generator().manual_seed(1234)
        try:
            self._run_evaluation(gen, 0)
            self.logger.log_values()
            for epoch in range(start_epoch, max_epochs):
                t0 = time.time()
                train_loss = self._run_epoch("train", gen, epoch)
                self._run_evaluation(gen, epoch)
                self.logger.add_value("Train/epoch_seconds", time.time() - t0)
                self.logger.log_values()
                print(f"epoch {epoch}: train loss {train_loss:.5f} ({time.time() - t0:.1f}s)")
                if self.save_window and max_epochs - epoch <= self.save_window:
                    self.avg.add(dict(self.task.named_parameters()), 1.0 / self.save_window)
                if self.rank == 0:  # the ranks hold the same weights
                    save_state(os.path.join(self.out_dir, "last_state.ckpt"), self.task,
                               self.opts, self.path_state, epoch, self.tokens)
            if self.rank == 0:
                save_checkpoint(self.checkpoint_path, self.task, self.avg.value())
        finally:
            self.logger.close()
        return self.task
