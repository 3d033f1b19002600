"""Detection-aware image transforms on the host, PIL + numpy (a frozen copy of
the port's module; counterpart of interactron_tpu/data/transforms.py).

  eval:  Resize(shorter->300, max 300) -> normalize; boxes scale to the new
         size and convert xyxy pixels -> normalized cxcywh.
  train: HFlip(0.5) -> RandomResize([400, 500, 600]) -> a 300x300 crop at a
         random offset -> Resize(300, max 300) -> normalize. The crop clamps
         boxes to the region and drops boxes with no area.

The train transform draws from the `np.random.RandomState` it is given, in
the JAX package's order (the flip's `rand`, the scale's `choice`, the
crop's two `randint`s), so one seed gives one augmentation in both.
Output is channels-last float32 (H, W, 3).
"""

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _resize_size(w, h, size, max_size=None):
    """Shorter side to `size`, the longer capped at `max_size`."""
    if max_size is not None:
        mn, mx = float(min(w, h)), float(max(w, h))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return w, h
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


def resize(img, boxes, size, max_size=None):
    w, h = img.size
    ow, oh = _resize_size(w, h, size, max_size)
    img = img.resize((ow, oh), Image.BILINEAR)
    if boxes is not None and len(boxes):
        boxes = boxes * np.asarray([ow / w, oh / h, ow / w, oh / h], np.float32)
    return img, boxes


def hflip(img, boxes):
    w = img.size[0]
    img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if boxes is not None and len(boxes):
        boxes = np.stack([w - boxes[:, 2], boxes[:, 1], w - boxes[:, 0], boxes[:, 3]], axis=1)
    return img, boxes


def crop(img, boxes, labels, region):
    """region = (top, left, h, w): the cropped image, and the boxes clamped
    to it with those of no area dropped."""
    top, left, h, w = region
    img = img.crop((left, top, left + w, top + h))
    if boxes is not None and len(boxes):
        b = boxes - np.asarray([left, top, left, top], np.float32)
        b = np.minimum(b.reshape(-1, 2, 2), np.asarray([w, h], np.float32))
        b = np.clip(b, 0, None).reshape(-1, 4)
        keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        boxes, labels = b[keep], labels[keep]
    return img, boxes, labels


def normalize_image(img):
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return (arr[..., :3] - IMAGENET_MEAN) / IMAGENET_STD


def boxes_to_cxcywh_norm(boxes, w, h):
    if boxes is None or len(boxes) == 0:
        return np.zeros((0, 4), np.float32)
    cx = (boxes[:, 0] + boxes[:, 2]) / 2 / w
    cy = (boxes[:, 1] + boxes[:, 3]) / 2 / h
    bw = (boxes[:, 2] - boxes[:, 0]) / w
    bh = (boxes[:, 3] - boxes[:, 1]) / h
    return np.stack([cx, cy, bw, bh], axis=1).astype(np.float32)


class EvalTransform:
    def __init__(self, resolution=300):
        self.resolution = resolution

    def __call__(self, img, boxes, labels, rng=None):
        img, boxes = resize(img, boxes, self.resolution, max_size=self.resolution)
        w, h = img.size
        return normalize_image(img), boxes_to_cxcywh_norm(boxes, w, h), labels


class TrainTransform:
    def __init__(self, resolution=300, scales=(400, 500, 600)):
        self.resolution = resolution
        self.scales = scales

    def __call__(self, img, boxes, labels, rng):
        if rng.rand() < 0.5:
            img, boxes = hflip(img, boxes)
        img, boxes = resize(img, boxes, int(rng.choice(self.scales)))
        W, H = img.size
        cw = min(W, self.resolution)
        ch = min(H, self.resolution)
        left = int(rng.randint(0, W - cw + 1))
        top = int(rng.randint(0, H - ch + 1))
        img, boxes, labels = crop(img, boxes, labels, (top, left, ch, cw))
        img, boxes = resize(img, boxes, self.resolution, max_size=self.resolution)
        w, h = img.size
        return normalize_image(img), boxes_to_cxcywh_norm(boxes, w, h), labels


def inv_transform(frame):
    """Normalized (H, W, 3) float32 -> PIL image."""
    arr = frame * IMAGENET_STD + IMAGENET_MEAN
    return Image.fromarray(np.clip(arr * 255, 0, 255).astype(np.uint8))
