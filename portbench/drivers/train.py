"""Meta-train traffic: `Trainer.train_step` over the port's `EpisodeLoader`.

Traffic parameters: `batch` episodes a step, `episodes` and `states` of
the seeded JPEG tree written at set-up under TMPDIR with the benchmark's
copy of the synthetic writer (`max_det` boxes a frame at most, of
`categories` classes), read by
TRAINER.NUM_WORKERS loader threads with the train transform; each epoch
reshuffles with its own loader seed. Dropout is on.

Set-up builds the one task and trainer the window uses and drives them
through their first three steps on the loader's first three batches
(rows that all differ); those are the steps the reference follows. The
window then runs whole steps until `--seconds` have passed: `train_eps`
is their episodes over the time from the first step's start to the last
step's end.
"""

import contextlib
import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.lib import compare, weights
from portbench.lib.precision import fp32
from portbench.lib.synthetic import make_synthetic_dataset
from portbench.reference import constants as C
from portbench.reference.config import Config as RefConfig
from portbench.reference.data import TrainEpisodes
from portbench.reference.task import ReferenceTask
from portbench.reference.train import ReferenceTrainer

COMPARED_STEPS = 3


def loader_seed(seed, epoch):
    return (seed * 7919 + epoch) % (2**31 - 1)


def _three_steps(step, modules, opts, keeping):
    """Losses of three steps, the inner gradients of the first step's
    microbatches (kept by the context `keeping`, which yields the list they
    go to), the first step's per-leaf gradient norms as Adam got them, and
    the per-leaf norms of the change after three."""
    before = compare.params(modules)
    with keeping() as kept:
        losses = [step()]
    grads = compare.norms(compare.first_moments(opts, modules))
    losses += [step() for _ in range(COMPARED_STEPS - 1)]
    change = compare.norms({n: p - before[n] for n, p in compare.params(modules).items()})
    return {"losses": losses, "inner_g": kept, "grads": grads, "change": change}


@contextlib.contextmanager
def _program_keeping():
    """Keep each microbatch's inner gradient g as the program's train step
    derives it: the stopped g its detector pass steps by (the call of
    tasks/interactron.py's clipped_sgd_step that takes the inner dtype)."""
    from interactron_tpu_torch.tasks import interactron

    kept, step = [], interactron.clipped_sgd_step

    def keeping_step(params, grads, lr, *a, **kw):
        if "dtype" in kw:
            kept.append({"g": {k: v.detach().cpu() for k, v in grads.items()}})
        return step(params, grads, lr, *a, **kw)

    interactron.clipped_sgd_step = keeping_step
    try:
        yield kept
    finally:
        interactron.clipped_sgd_step = step


def prepare(run):
    """The inputs both sides get: the weights (made by the benchmark on the
    device from the seed) and the JPEG tree."""
    tr = run.traffic
    cfg = run.model_config
    size = int(cfg["MODEL"]["TEST_RESOLUTION"])
    ref = ReferenceTask(RefConfig(cfg), run.device)
    run.weights = {k: v.cpu() for k, v in weights.make(ref, run.seed, size).items()}
    del ref
    run.tree = tempfile.mkdtemp(prefix="portbench-tree-")
    run.img_root, run.ann = make_synthetic_dataset(
        run.tree, n_episodes=tr["episodes"], n_states=tr["states"], img_size=size,
        max_det=tr["max_det"], n_categories=tr["categories"], seed=run.seed % 2**32)


def setup(run):
    from interactron_tpu_torch.data.episode_dataset import EpisodeDataset, EpisodeLoader
    from interactron_tpu_torch.engine.trainer import Trainer
    from interactron_tpu_torch.utils.config import Config, build_model

    prepare(run)
    tr = run.traffic
    cfg = run.model_config
    task = build_model(Config(cfg), device=run.device)
    task.load_state_dict(run.weights)
    trainer = Trainer(task, Config(cfg), path_rows=tr["episodes"] + 1)
    dataset = EpisodeDataset(run.img_root, run.ann, mode="train", train_aug=True,
                             resolution=task.img_size, max_boxes=task.max_boxes)
    workers = int(cfg["TRAINER"]["NUM_WORKERS"])

    def batches():
        epoch = 0
        while True:
            yield from EpisodeLoader(dataset, tr["batch"], shuffle=True, num_workers=workers,
                                     seed=loader_seed(run.seed, epoch), drop_last=True)
            epoch += 1

    run.batches = batches()
    run.gen = torch.Generator().manual_seed(run.seed)
    run.objects.update(task=task, trainer=trainer)
    if run.fault == "state_unchanged":
        trainer.apply_grads = lambda grads, lr_scale=1.0: torch.zeros(())
    elif run.fault == "half_batch":
        step = trainer.train_step
        trainer.train_step = lambda b, gen: step(
            {k: v[:len(v) // 2] for k, v in b.items()}, gen)
    run.program = _three_steps(lambda: _step(run)[0], task.modules_by_group(), trainer.opts,
                               _program_keeping)


def _step(run):
    """One train step on the loader's next batch: (mean total loss,
    episodes); the wait for the batch is the `loader_wait` span."""
    t0 = time.perf_counter()
    batch = next(run.batches)
    if run.tracing:
        run.record("loader_wait", time.perf_counter() - t0)
    metrics = run.objects["trainer"].train_step(batch, run.gen)
    return float(metrics["total_loss"]), len(batch["frames"])


def window(run):
    run.sync()
    t0 = time.perf_counter()
    steps = episodes = failed = 0
    while True:
        loss, n = _step(run)
        steps += 1
        episodes += n
        failed += 0 if np.isfinite(loss) else n
        run.sync()
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window.update(seconds=time.perf_counter() - t0, steps=steps, episodes=episodes,
                      attempted=episodes, failed=failed)


def stretch(run):
    from portbench.lib.profile import profile

    return profile(run, lambda: _step(run), run.traffic["batch"])


def _reference_steps(run, mode=None):
    """The reference's three steps on batches it reads from the tree, under
    the dispatch mode `mode` (the control's precision) if given."""
    cfg = run.model_config
    tr = run.traffic
    with fp32(), (mode or contextlib.nullcontext()):
        ref = compare.reference(cfg, run.weights, run.device)
        rt = ReferenceTrainer(ref, RefConfig(cfg).TRAINER, tr["episodes"] + 1)
        data = TrainEpisodes(run.img_root, run.ann, int(cfg["MODEL"]["TEST_RESOLUTION"]),
                             min(C.MAX_BOXES, ref.detector.num_queries))
        gen = torch.Generator().manual_seed(run.seed)
        per_epoch = tr["episodes"] // tr["batch"]
        it = iter(range(COMPARED_STEPS))

        def step():
            i = next(it)
            seed = loader_seed(run.seed, i // per_epoch)
            return rt.step(data.batch(seed, i % per_epoch, tr["batch"]), gen)

        @contextlib.contextmanager
        def keeping():
            ref.kept_g = []
            try:
                yield ref.kept_g
            finally:
                ref.kept_g = None

        return _three_steps(step, ref.modules_by_group(), rt.opts, keeping)


def control(run):
    """The control in the program's place: the reference with its matmuls
    and convolutions in fp8."""
    from portbench.lib.precision import Fp8Matmuls

    prepare(run)
    run.program = _reference_steps(run, Fp8Matmuls())


def check(run):
    """Free the program, then follow its first three steps with the fp32
    reference on batches it reads from the same tree."""
    if hasattr(run, "batches"):
        run.batches.close()  # joins the loader's threads
    run.objects.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    try:
        run.reference = _reference_steps(run)
    finally:
        shutil.rmtree(run.tree, ignore_errors=True)
    names, read = compare.train_numbers(run.program, run.reference)
    run.extra = {**read, "losses": run.program["losses"],
                 "reference_losses": run.reference["losses"],
                 "grad_gap": compare.worst_gap(run.program["grads"], run.reference["grads"])}
    return [(name, value, float(run.limits[name])) for name, value in names]
