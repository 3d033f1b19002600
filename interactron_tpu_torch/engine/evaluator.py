"""Evaluators (counterpart of interactron_tpu/engine/evaluator.py): offline
episode replay with the fixed test path, and the closed-loop interactive
evaluation, with the reference's scoring and AP (engine/ap.py).

Evaluation scores frame 0 of each episode only. Predict and next_action run
on the task's device; the matching and AP run on the host. The evaluators
evaluate the task's own weights: the first evaluation that is not handed
trained weights draws them from seed 42 and loads EVALUATOR.CHECKPOINT when
asked to and the file exists (JAX's `ensure_params`).

The interactive evaluator of a task with a policy rolls chunks of
EVALUATOR.ROLLOUT_BATCH episodes (default 10) forward in lockstep, as JAX's
does: one batched next_action per prefix length s = 1..4 and one batched
adaptive predict per chunk, each episode with its own fast weights, then
frame-0 scoring per episode in episode order. Its records are the serial
rollout's (ROLLOUT_BATCH: 1, which runs the same calls on one episode at a
time). A task without a policy takes random actions one episode at a time.
"""

import concurrent.futures as cf
import json
import os
from datetime import datetime

import numpy as np
from PIL import ImageDraw

from interactron_tpu_torch.data.episode_dataset import (
    EpisodeDataset,
    EpisodeLoader,
    InteractiveEpisodeDataset,
)
from interactron_tpu_torch.data.transforms import inv_transform
from interactron_tpu_torch.engine.ap import ap_summary, compute_ap, score_frame
from interactron_tpu_torch.utils import constants as C
from interactron_tpu_torch.utils import profiling
from interactron_tpu_torch.utils.checkpoint import load_checkpoint


class _EvaluatorBase:
    dataset_cls = EpisodeDataset

    def __init__(self, task, config, load_checkpoint=False):
        self.task = task
        self.config = config
        self.load_checkpoint_flag = load_checkpoint
        self.out_dir = os.path.join(
            config.EVALUATOR.OUTPUT_DIRECTORY, datetime.now().strftime("%m-%d-%Y-%H:%M:%S"))
        self.weights_ready = False
        ds = config.DATASET.TEST
        self.dataset = self.dataset_cls(
            ds.IMAGE_ROOT, ds.ANNOTATION_ROOT, ds.MODE, train_aug=False,
            resolution=task.img_size, max_boxes=task.max_boxes)

    def ensure_params(self, trained=False):
        """`trained`: evaluate the task's weights as they are (the trainer's
        call). Otherwise, on the first call, draw them from seed 42 and load
        EVALUATOR.CHECKPOINT when asked to and it exists."""
        if trained:
            self.weights_ready = True
        if self.weights_ready:
            return
        self.task.init(42)
        if self.load_checkpoint_flag:
            path = self.config.EVALUATOR.get("CHECKPOINT")
            if path and os.path.exists(path):
                load_checkpoint(path, self.task)
        self.weights_ready = True

    # ---------------------------------------------------------------- common

    def _score_episode(self, batch, predictions):
        """Frame-0 scoring -> detection records."""
        valid = np.asarray(batch["valid"])[0, 0]
        return score_frame(
            predictions["pred_logits"][0, 0],
            predictions["pred_boxes"][0, 0],
            np.asarray(batch["boxes"])[0, 0][valid],
            np.asarray(batch["labels"])[0, 0][valid],
            batch["initial_image_path"][0],
            num_classes=self.task.num_classes,
        )

    def _finish(self, detections, save_results):
        tps = [d for d in detections if d["type"] == "tp"]
        fps = [d for d in detections if d["type"] == "fp"]
        fns = [d for d in detections if d["type"] == "fn"]
        ap_50 = compute_ap(detections, iou_thresholds=[0.5])
        ap = compute_ap(detections, iou_thresholds=list(np.arange(0.5, 1.0, 0.05)))
        if not save_results:
            return ap_50, ap, len(tps), len(fps), len(fns)
        summary = ap_summary(detections)
        print(
            "AP_50:", summary["AP_50"], "AP_75", summary["AP_75"], "AP", summary["AP"],
            "AP_small", summary["AP_small"], "AP_medium", summary["AP_medium"],
            "AP_large", summary["AP_large"],
        )
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "results.json"), "w") as f:
            json.dump({"AP_50": summary["AP_50"], "summary": summary, "detections": detections}, f)
        return summary

    def _save_image(self, batch, img_detections):
        """Annotated 1200x1200 dump of frame 0."""
        img = inv_transform(np.asarray(batch["frames"])[0, 0]).resize((1200, 1200))
        draw = ImageDraw.Draw(img)
        for det in img_detections:
            if det["type"] == "fn" or (det["type"] == "fp" and det["pred_score"] > 0.5):
                continue
            color = "blue" if det["type"] == "tp" and det["iou"] >= 0.5 else (
                "black" if det["type"] == "tp" else None)
            if color is None:
                continue
            draw.rectangle([1200 * c for c in det["box"]], outline=color, width=2)
            name = (C.tlvis_classes[det["pred_cat"]] if det["pred_cat"] < len(C.tlvis_classes)
                    else str(det["pred_cat"]))
            draw.text((1200 * det["box"][0], 1200 * max(det["box"][1] - 0.02, 0)), name,
                      fill=color)
        img_root = os.path.join(self.out_dir, "images")
        os.makedirs(img_root, exist_ok=True)
        img.save(os.path.join(img_root, os.path.basename(img_detections[0]["img"])))

    def _record(self, batch, predictions, detections, save_results):
        ep_dets = self._score_episode(batch, predictions)
        detections += ep_dets
        if save_results and ep_dets:
            self._save_image(batch, ep_dets)


class RandomPolicyEvaluator(_EvaluatorBase):
    """Replays the test episodes along the fixed 5-action path."""

    def evaluate(self, save_results=False, trained=False):
        """(AP50, AP, TP, FP, FN), or with `save_results` the AP summary
        (written to `out_dir` with the records and annotated frames)."""
        self.ensure_params(trained)
        loader = EpisodeLoader(self.dataset, batch_size=1, shuffle=False,
                               num_workers=int(self.config.EVALUATOR.get("NUM_WORKERS", 1)))
        detections = []
        for batch in loader:
            self._record(batch, self.task.predict(batch), detections, save_results)
        return self._finish(detections, save_results)


class InteractiveEvaluator(_EvaluatorBase):
    """Closed-loop policy evaluation: reset, four times next_action -> step,
    then the adaptive predict and frame-0 scoring; in lockstep over chunks
    of ROLLOUT_BATCH episodes when the task has a policy. A task without a
    policy takes uniformly random actions, one episode at a time."""

    dataset_cls = InteractiveEpisodeDataset

    def __init__(self, task, config, load_checkpoint=False):
        super().__init__(task, config, load_checkpoint)
        self.has_policy = hasattr(task, "next_action")
        self.rollout_batch = int(config.EVALUATOR.get("ROLLOUT_BATCH", 10))

    @property
    def chunk(self):
        """Episodes rolled out together: ROLLOUT_BATCH, at most the test
        set's; 1 for a task without a policy."""
        return max(1, min(self.rollout_batch, len(self.dataset))) if self.has_policy else 1

    def evaluate(self, save_results=False, trained=False):
        """As RandomPolicyEvaluator.evaluate."""
        self.ensure_params(trained)
        if self.has_policy:
            return self._evaluate_lockstep(save_results, self.chunk)
        detections = []
        for _ in range(len(self.dataset)):
            batch = self.dataset.reset()
            for _ in range(C.NUM_FRAMES - 1):
                batch = self.dataset.step(int(np.random.randint(0, C.NUM_ACTIONS)))
            self._record(batch, self.task.predict(batch), detections, save_results)
        return self._finish(detections, save_results)

    def _evaluate_lockstep(self, save_results, rb):
        """Chunks of `rb` episodes in episode order (<- `_evaluate_lockstep`),
        the last one possibly shorter (JAX pads it with copies of its last
        episode and drops their rows; nothing here compiles per shape). The
        replays are read by 4 threads; the eval transform draws nothing
        from the dataset's generator, so the threads cannot change a
        sample."""
        ds = self.dataset
        n = len(ds)
        detections = []
        with cf.ThreadPoolExecutor(max_workers=4) as pool:
            for start in range(0, n, rb):
                idxs = list(range(start, min(start + rb, n)))
                acts = [[] for _ in idxs]

                def replay():
                    samples = list(pool.map(lambda j: ds.partial_sample(idxs[j], acts[j]),
                                            range(len(idxs))))
                    return samples, {"frames": np.concatenate([s["frames"] for s in samples])}

                for _ in range(C.NUM_FRAMES - 1):
                    _, batch = replay()
                    actions = self.task.next_action(batch)
                    with profiling.sync("actions_to_host", cuda=actions.is_cuda):
                        actions = actions.tolist()
                    for j, a in enumerate(actions):
                        acts[j].append(C.ACTIONS[a])
                samples, batch = replay()
                preds = self.task.predict(batch)
                with profiling.sync("predictions_to_host", n=len(preds),
                                    cuda=any(v.is_cuda for v in preds.values())):
                    preds = {k: v.cpu() for k, v in preds.items()}
                for j, sample in enumerate(samples):
                    self._record(sample, {k: v[j:j + 1] for k, v in preds.items()}, detections,
                                 save_results)
        return self._finish(detections, save_results)
