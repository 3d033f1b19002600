"""Train batches read again from an episode tree on disk: a frozen copy of
the port's data/episode_dataset.py in train mode (the train transform,
PIL decode), without threads or the native loader.

Batch i of an epoch with loader seed `seed` holds the episodes of
`RandomState(seed).shuffle(arange(n))[i*b:(i+1)*b]`, and episode j draws
its five actions, then its augmentations, from `RandomState((seed *
1000003 + j) % (2**31 - 1))`, as the port's loader does.
"""

import json
import os

import numpy as np
from PIL import Image

from portbench.reference import constants as C
from portbench.reference.transforms import TrainTransform


class TrainEpisodes:
    def __init__(self, img_root, annotations_path, resolution, max_boxes):
        with open(annotations_path) as f:
            self.annotations = json.load(f)
        self.img_dir = img_root.rstrip("/")
        self.transform = TrainTransform(resolution)
        self.max_boxes = max_boxes

    def __len__(self):
        return len(self.annotations["data"])

    def _state(self, scene, state_name, rng):
        boxes, labels = [], []
        for v in scene["state_table"][state_name]["detections"].values():
            labels.append(v["category_id"] + 1)
            x, y, w, h = v["bbox"]
            boxes.append([x, y, x + w, y + h])
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        path = os.path.join(self.img_dir, scene["scene_name"], state_name + ".jpg")
        with Image.open(path) as frame:
            img, boxes, labels = self.transform(frame, boxes, np.asarray(labels, np.int64), rng)
        m = self.max_boxes
        n = min(len(labels), m)
        pb, pl, pv = np.zeros((m, 4), np.float32), np.zeros((m,), np.int32), np.zeros((m,), bool)
        pb[:n], pl[:n], pv[:n] = boxes[:n], labels[:n], True
        return img, pb, pl, pv

    def episode(self, idx, seed):
        rng = np.random.RandomState((seed * 1000003 + int(idx)) % (2**31 - 1))
        actions = [rng.choice(self.annotations["metadata"]["actions"])
                   for _ in range(C.NUM_FRAMES)]
        scene = self.annotations["data"][idx]
        names = [scene["root"]]
        for a in actions[:C.NUM_FRAMES - 1]:
            names.append(scene["state_table"][names[-1]]["actions"][a])
        parts = [self._state(scene, name, rng) for name in names]
        return {"frames": np.stack([p[0] for p in parts]).astype(np.float32),
                "boxes": np.stack([p[1] for p in parts]),
                "labels": np.stack([p[2] for p in parts]),
                "valid": np.stack([p[3] for p in parts]),
                "actions": np.asarray([C.ACTIONS.index(a) for a in actions], np.int32),
                "episode_uid": np.int32(idx)}

    def batch(self, seed, i, batch_size):
        """Batch i of the shuffled epoch whose loader seed is `seed`."""
        order = np.arange(len(self))
        np.random.RandomState(seed).shuffle(order)
        eps = [self.episode(j, seed) for j in order[i * batch_size:(i + 1) * batch_size]]
        return {k: np.stack([e[k] for e in eps]) for k in eps[0]}
