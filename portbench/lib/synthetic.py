"""Synthetic episode tree (a copy of the port's data/synthetic.py, so the
benchmark's inputs do not change with the program).

Writes a miniature dataset in the `interactron_v1_*.json` schema with
procedurally drawn JPEGs whose detections are colored rectangles: enough
for the loader, the transforms, the model, the criterion and AP to run
without the iTHOR data. One seed writes the same tree, JPEG bytes included.
"""

import json
import os

import numpy as np
from PIL import Image, ImageDraw

from portbench.reference import constants as C

_COLORS = [
    (200, 60, 60), (60, 180, 60), (60, 60, 200), (200, 200, 60),
    (200, 60, 200), (60, 200, 200), (230, 140, 40), (120, 120, 220),
]


def make_synthetic_dataset(root, n_episodes=4, n_states=8, img_size=300, n_categories=12,
                           max_det=4, seed=0):
    """Create {root}/images/... and {root}/annotations.json. Returns the
    (img_root, annotations_path) pair."""
    rng = np.random.RandomState(seed)
    img_root = os.path.join(root, "images")
    os.makedirs(img_root, exist_ok=True)
    data = []
    for e in range(n_episodes):
        scene_name = f"FloorPlan_Syn{e}"
        scene_dir = os.path.join(img_root, scene_name)
        os.makedirs(scene_dir, exist_ok=True)
        states = [f"s{e}_{i}" for i in range(n_states)]
        state_table = {}
        for si, sname in enumerate(states):
            ndet = int(rng.randint(1, max_det + 1))
            dets = {}
            img = Image.new("RGB", (img_size, img_size), (230, 230, 230))
            draw = ImageDraw.Draw(img)
            for d in range(ndet):
                cat = int(rng.randint(0, n_categories))
                w = int(rng.randint(img_size // 10, img_size // 3))
                h = int(rng.randint(img_size // 10, img_size // 3))
                x = int(rng.randint(0, img_size - w))
                y = int(rng.randint(0, img_size - h))
                draw.rectangle([x, y, x + w, y + h], fill=_COLORS[cat % len(_COLORS)])
                dets[f"obj_{si}_{d}"] = {"category_id": cat, "bbox": [x, y, w, h]}
            img.save(os.path.join(scene_dir, sname + ".jpg"), quality=90)
            # every action leads to a pseudo-random but deterministic state
            actions = {a: states[(si * 7 + 3 * ai + 1) % n_states]
                       for ai, a in enumerate(C.ACTIONS)}
            state_table[sname] = {"detections": dets, "actions": actions}
        data.append({"scene_name": scene_name, "root": states[0], "state_table": state_table})
    ann = {"data": data, "metadata": {"actions": list(C.ACTIONS)}}
    ann_path = os.path.join(root, "annotations.json")
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return img_root, ann_path
