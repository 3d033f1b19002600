"""Episode replay datasets over the precollected iTHOR trees (own copy of
interactron_tpu/data/episode_dataset.py).

Reads the `interactron_v1_{train,test}.json` schema:

  {"data": [{"scene_name", "root", "state_table":
      {state: {"detections": {obj: {"category_id", "bbox"[x,y,w,h]}},
               "actions": {action_name: next_state}}}],
   "metadata": {"actions": [...]}}

Samples are fixed-shape numpy arrays (frames NHWC float32, targets padded
to `max_boxes` with a validity mask); the tasks move them to their device.
Category ids are offset by +1 at load; test mode walks the fixed 5-action
path. Images are decoded by PIL, but for the deterministic eval transform
(`train_aug=False`), where `get_item` decodes and normalizes an episode's
five JPEGs in one call of the native loader (native/, as the JAX package
does) when it is built; an episode whose images are not at the target
resolution falls back to PIL.
"""

import concurrent.futures as cf
import json
import os

import numpy as np
from PIL import Image

from interactron_tpu_torch.data.transforms import (
    EvalTransform,
    TrainTransform,
    boxes_to_cxcywh_norm,
)
from interactron_tpu_torch.utils import constants as C
from interactron_tpu_torch.utils import profiling

FIXED_TEST_PATH = ["RotateLeft", "MoveAhead", "RotateLeft", "MoveBack", "RotateRight"]


def _action_ids(actions):
    return np.asarray([C.ACTIONS.index(a) for a in actions], np.int32)


class EpisodeDataset:
    def __init__(self, img_root, annotations_path, mode="train", train_aug=False,
                 max_boxes=C.MAX_BOXES, resolution=C.IMG_SIZE, seed=0, uid_offset=0):
        if mode not in ("train", "test"):
            raise ValueError(f"mode {mode!r} is neither 'train' nor 'test'")
        self.uid_offset = uid_offset
        self.mode = mode
        with open(annotations_path) as f:
            self.annotations = json.load(f)
        self.img_dir = img_root.rstrip("/")
        self.transform = TrainTransform(resolution) if train_aug else EvalTransform(resolution)
        self.max_boxes = max_boxes
        self.resolution = resolution
        self.rng = np.random.RandomState(seed)
        self._native = None
        if not train_aug:
            from interactron_tpu_torch.native import get_fastloader

            self._native = get_fastloader()

    def __len__(self):
        return len(self.annotations["data"])

    def _img_path(self, scene, state_name):
        return os.path.join(self.img_dir, scene["scene_name"], state_name + ".jpg")

    def _state_targets(self, scene, state_name):
        """The xyxy pixel boxes and the labels (category id + 1) of a state."""
        boxes, labels = [], []
        for v in scene["state_table"][state_name]["detections"].values():
            labels.append(v["category_id"] + 1)
            x, y, w, h = v["bbox"]
            boxes.append([x, y, x + w, y + h])
        return np.asarray(boxes, np.float32).reshape(-1, 4), np.asarray(labels, np.int64)

    def _load_state(self, scene, state_name, rng):
        """The transformed frame of one state, its boxes (normalized cxcywh)
        and its labels."""
        boxes, labels = self._state_targets(scene, state_name)
        with Image.open(self._img_path(scene, state_name)) as frame:
            return self.transform(frame, boxes, labels, rng)

    def _pad_targets(self, boxes, labels):
        m = self.max_boxes
        n = min(len(labels), m)
        pb = np.zeros((m, 4), np.float32)
        pl = np.zeros((m,), np.int32)
        pv = np.zeros((m,), bool)
        pb[:n] = boxes[:n]
        pl[:n] = labels[:n]
        pv[:n] = True
        return pb, pl, pv

    def _native_frames(self, scene, state_names):
        """The states' frames decoded and normalized in one native call, or
        None without the loader or when an image is not at the target
        resolution (the loader's ValueError)."""
        if self._native is None:
            return None
        paths = [self._img_path(scene, s) for s in state_names]
        try:
            return self._native.load_images(paths, self.resolution)
        except ValueError:
            return None

    def _replay(self, idx, actions, rng, native=False):
        """Frames, padded targets, uid and root image path of the
        len(actions)+1 states that episode `idx` visits from its root under
        `actions` (names); with `native`, through the native loader where
        it serves the episode."""
        scene = self.annotations["data"][idx]
        state_names = [scene["root"]]
        for a in actions:
            state_names.append(scene["state_table"][state_names[-1]]["actions"][a])
        imgs = self._native_frames(scene, state_names) if native else None
        frames, b_list, l_list, v_list = [], [], [], []
        for state_name in state_names:
            if imgs is None:
                img, boxes, labels = self._load_state(scene, state_name, rng)
                frames.append(img)
            else:
                boxes, labels = self._state_targets(scene, state_name)
                boxes = boxes_to_cxcywh_norm(boxes, self.resolution, self.resolution)
            pb, pl, pv = self._pad_targets(boxes, labels)
            b_list.append(pb)
            l_list.append(pl)
            v_list.append(pv)
        return {
            "frames": imgs if imgs is not None else np.stack(frames).astype(np.float32),
            "labels": np.stack(l_list),
            "boxes": np.stack(b_list),
            "valid": np.stack(v_list),
            "episode_uid": np.int32(idx + self.uid_offset),
            "initial_image_path": os.path.join(self.img_dir, scene["scene_name"],
                                               scene["root"] + ".jpg"),
        }

    def get_item(self, idx, actions=None, rng=None):
        """One 5-frame episode. The loader's threads pass a per-item `rng`;
        the dataset's own is for single-threaded access. In train mode the
        five actions are drawn before any image is loaded."""
        rng = rng if rng is not None else self.rng
        if self.mode == "test" and actions is None:
            actions = FIXED_TEST_PATH
        if actions is None:
            actions = [rng.choice(self.annotations["metadata"]["actions"])
                       for _ in range(C.NUM_FRAMES)]
        sample = self._replay(idx, actions[:C.NUM_FRAMES - 1], rng, native=True)
        sample["actions"] = _action_ids(actions)
        return sample

    __getitem__ = get_item


def collate(samples):
    batch = {
        k: np.stack([s[k] for s in samples])
        for k in ("frames", "actions", "labels", "boxes", "valid", "episode_uid")
    }
    batch["initial_image_path"] = [s["initial_image_path"] for s in samples]
    return batch


class EpisodeLoader:
    """Batch loader: `num_workers` threads decode and augment numpy into an
    ordered table of slots, at most `prefetch + num_workers` batches ahead,
    and batches come out in index order. Item i of an epoch draws from
    `RandomState((seed * 1000003 + i) % (2**31 - 1))`, so a batch does not
    depend on the thread that loaded it.

    Over `process_count` ranks (parallel/mesh.py) `batch_size` is the
    global batch: rank `process_index` loads the contiguous slice of each
    index batch that is its own, and a tail batch that the ranks do not
    divide whole, on every rank (<- `_local_slice`). The shuffle is
    seeded, so the ranks agree on the order without talking. There, each
    batch carries its global episode count as `_global_rows`."""

    def __init__(self, dataset, batch_size, shuffle=False, num_workers=2, prefetch=2,
                 drop_last=True, seed=0, process_index=0, process_count=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.rng_seed = seed
        self.rng = np.random.RandomState(seed)
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for i in range(len(self)):
            yield idx[i * self.batch_size:(i + 1) * self.batch_size]

    def _load(self, i):
        rng = np.random.RandomState((self.rng_seed * 1000003 + int(i)) % (2**31 - 1))
        return self.dataset.get_item(int(i), rng=rng)

    def _local_slice(self, ib):
        """This rank's part of a global index batch, and the batch's size."""
        g = len(ib)
        if self.process_count > 1 and g % self.process_count == 0:
            n = g // self.process_count
            ib = ib[self.process_index * n:(self.process_index + 1) * n]
        return ib, g

    def _emit(self, ib):
        local, g = self._local_slice(ib)
        with profiling.span("loader.batch", episodes=len(local)):
            batch = collate([self._load(i) for i in local])
        if self.process_count > 1:
            batch["_global_rows"] = g
        return batch

    @staticmethod
    def _wait(future):
        """The consumer's wait for the batch at the head: `loader.wait`,
        counted in `loader.batches`, and in `loader.late` when the batch was
        not ready as it was asked for (always without workers)."""
        profiling.count("loader.batches")
        if future is None or not future.done():
            profiling.count("loader.late")
        return profiling.span("loader.wait")

    def __iter__(self):
        if self.num_workers == 0:
            for ib in self._index_batches():
                with self._wait(None):
                    batch = self._emit(ib)
                yield batch
            return
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = []
            for ib in self._index_batches():
                futures.append(pool.submit(self._emit, ib))
                while len(futures) > self.prefetch + self.num_workers:
                    f = futures.pop(0)
                    with self._wait(f):
                        batch = f.result()
                    yield batch
            for f in futures:
                with self._wait(f):
                    batch = f.result()
                yield batch


class InteractiveEpisodeDataset(EpisodeDataset):
    """Gym-style closed-loop replay: reset() moves to the next episode and
    returns its 1-frame sample; step(action) replays the prefix and returns
    the (len+1)-frame sample."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.idx = -1
        self.actions = []

    def partial_sample(self, idx, actions):
        """The (len(actions)+1)-frame sample of episode `idx` after taking
        `actions` (names), with a batch dimension of 1. The uid is `idx`,
        without `uid_offset`, as in the JAX package."""
        s = self._replay(idx, actions, self.rng)
        s["actions"] = _action_ids(actions)
        batch = {k: s[k][None] for k in ("frames", "actions", "labels", "boxes", "valid")}
        batch["episode_uid"] = np.asarray([idx], np.int32)
        batch["initial_image_path"] = [s["initial_image_path"]]
        return batch

    def reset(self):
        self.idx += 1
        if self.idx >= len(self.annotations["data"]):
            self.idx = 0
        self.actions = []
        return self.partial_sample(self.idx, self.actions)

    def step(self, action):
        self.actions.append(C.ACTIONS[int(action)])
        return self.partial_sample(self.idx, self.actions)
