"""Offline AI2-THOR episode-tree collector (own copy of
interactron_tpu/collect/thor_collector.py). A host-side tool: the train
and evaluation loops replay the collected trees and never talk to the
simulator.

  * 80 train / 20 val / 20 test FloorPlans (20/5/5 from each of kitchens,
    living rooms, bedrooms, bathrooms);
  * Controller at 300x300, 30-degree rotations, grid 0.25, depth and
    instance segmentation on;
  * per anchor: a random reachable pose until >= 3 detectable objects (the
    THOR class mapped into the 1235-way LVIS+THOR vocabulary of
    utils/constants.py), then a recursive 4-step expansion of all 4 actions
    deduplicated by pose id, kept only if every terminal path is >= 4 steps
    deep;
  * writes per-state JPEGs plus one interactron_v1_{train,test}.json, the
    schema data/episode_dataset.py reads.

ai2thor (and its Unity binary) is imported only by `ThorCollector()`
without a controller: this module imports everywhere, and a scripted
controller can stand in for the simulator.
"""

import json
import os
import random
import warnings

import numpy as np

from interactron_tpu_torch.utils.constants import ACTIONS, _vocab, tlvis_classes

NUM_STEPS = 4
ROT_ANGLE = 30

kitchens = [f"FloorPlan{i}" for i in range(1, 31)]
living_rooms = [f"FloorPlan{200 + i}" for i in range(1, 31)]
bedrooms = [f"FloorPlan{300 + i}" for i in range(1, 31)]
bathrooms = [f"FloorPlan{400 + i}" for i in range(1, 31)]
TRAIN_SCENES = kitchens[:20] + living_rooms[:20] + bedrooms[:20] + bathrooms[:20]
VAL_SCENES = kitchens[20:25] + living_rooms[20:25] + bedrooms[20:25] + bathrooms[20:25]
TEST_SCENES = kitchens[25:] + living_rooms[25:] + bedrooms[25:] + bathrooms[25:]


def korea_to_lvis():
    return _vocab["korea_to_lvis"]


def pos_to_id(state):
    return "pos=[%.2f,%.2f,%.2f]_rot=[%ddeg]" % (
        state["pos"]["x"], state["pos"]["y"], state["pos"]["z"], state["rot"]["y"]
    )


def _mask_has_polygon(mask):
    """A detection is kept only if its instance mask is a non-degenerate
    region: at least 3 pixels with 2D extent (the numpy stand-in for a
    >= 6-point contour)."""
    ys, xs = np.nonzero(mask)
    return len(ys) >= 3 and ys.max() > ys.min() and xs.max() > xs.min()


def _capture_state(event, hor, stand):
    """The state record of a controller event."""
    mapping = korea_to_lvis()
    detections = {}
    for name, box in event.instance_detections2D.items():
        cat = name.split("|")[0]
        if cat not in mapping:
            continue
        if name not in event.instance_masks or not _mask_has_polygon(event.instance_masks[name]):
            continue
        x0, y0, x1, y1 = (int(v) for v in box)
        detections[name] = {
            "category_id": tlvis_classes.index(mapping[cat]),
            "bbox": [x0, y0, x1 - x0, y1 - y0],
        }
    return {
        "pos": event.metadata["agent"]["position"],
        "rot": event.metadata["agent"]["rotation"],
        "hor": hor,
        "stand": stand,
        "img": np.asarray(event.frame),
        "detections": detections,
    }


def find_shortest_terminal_path(state, table, depth=0, max_depth=NUM_STEPS):
    actions = table[state]["actions"]
    if len(actions) == 0 or depth > max_depth:
        return depth
    return min(
        find_shortest_terminal_path(nxt, table, depth + 1, max_depth)
        for nxt in actions.values()
    )


class ThorCollector:
    def __init__(self, controller=None):
        if controller is None:
            try:
                from ai2thor.controller import Controller
            except ImportError as e:
                raise RuntimeError(
                    "ai2thor is not installed; pass a controller-compatible "
                    "object (see tests for a scripted fake) or install ai2thor"
                ) from e
            controller = Controller(
                rotateStepDegrees=ROT_ANGLE,
                renderDepthImage=True,
                renderInstanceSegmentation=True,
                height=300,
                width=300,
                gridSize=0.25,
                snapToGrid=False,
            )
        self.ctrl = controller

    def teleport_to(self, state):
        e = self.ctrl.step(
            action="TeleportFull",
            position=state["pos"],
            rotation=state["rot"],
            horizon=state["hor"],
            standing=state["stand"],
        )
        return _capture_state(e, state["hor"], state["stand"])

    def take_step(self, state, action):
        self.teleport_to(state)
        e = self.ctrl.step(action)
        return _capture_state(e, state["hor"], state["stand"])

    def rollout_rec(self, root_state, state_table, d=0):
        """Expand all 4 actions to depth NUM_STEPS, deduplicating states by
        pose id."""
        if d >= NUM_STEPS:
            return {}
        rid = pos_to_id(root_state)
        if rid in state_table and len(state_table[rid]["actions"]) > 0:
            steps = state_table[rid]["actions"]
        else:
            steps = {}
            for action in ACTIONS:
                new_state = self.take_step(root_state, action)
                nid = pos_to_id(new_state)
                steps[action] = nid
                if nid not in state_table:
                    state_table[nid] = new_state
                    state_table[nid]["actions"] = {}
        for state_name in steps.values():
            state = state_table[state_name]
            next_steps = self.rollout_rec(state, state_table, d=d + 1)
            if len(state_table[pos_to_id(state)]["actions"]) == 0:
                state_table[pos_to_id(state)]["actions"] = next_steps
        return steps

    def collect_anchor(self, scene, min_objects=3, rng=random):
        """One validated episode tree for a scene. Returns (root_id, table)."""
        rotations = [{"x": 0.0, "y": float(t), "z": 0.0} for t in range(0, 360, ROT_ANGLE)]
        while True:
            self.ctrl.reset(scene=scene)
            num_valid = 0
            while num_valid < min_objects:
                p = rng.choice(self.ctrl.step(action="GetReachablePositions").metadata["actionReturn"])
                root = self.teleport_to(
                    {"pos": p, "rot": rng.choice(rotations), "hor": 0, "stand": True}
                )
                num_valid = len(root["detections"])
            root_id = pos_to_id(root)
            table = {root_id: root}
            table[root_id]["actions"] = {}
            table[root_id]["actions"] = self.rollout_rec(root, table)
            if find_shortest_terminal_path(root_id, table) >= NUM_STEPS:
                return root_id, table

    def collect_dataset(self, split, img_root, ann_path, num_anchors=None):
        from PIL import Image

        train = split != "test"
        scenes = (TRAIN_SCENES + VAL_SCENES) if train else TEST_SCENES
        num_anchors = num_anchors if num_anchors is not None else (1000 if train else 100)
        if num_anchors % len(scenes) != 0:
            warnings.warn(
                f"num_anchors {num_anchors} not divisible by {len(scenes)} scenes; "
                f"reduced to {num_anchors // len(scenes)} per scene"
            )
        per_scene = max(1, num_anchors // len(scenes))
        annotations = {
            "data": [],
            "metadata": {
                "actions": list(ACTIONS),
                "max_steps": NUM_STEPS,
                "rotation_angle": ROT_ANGLE,
                "scenes": scenes,
            },
        }
        for scene in scenes:
            for i in range(per_scene):
                root_id, table = self.collect_anchor(scene)
                scene_name = "{}_{:05d}".format(scene, i)
                os.makedirs(os.path.join(img_root, scene_name), exist_ok=True)
                light = {}
                for name, f in table.items():
                    Image.fromarray(f["img"]).save(
                        os.path.join(img_root, scene_name, name + ".jpg"), quality=95
                    )
                    light[name] = {
                        "pos": f["pos"],
                        "rot": f["rot"],
                        "hor": f["hor"],
                        "stand": f["stand"],
                        "detections": f["detections"],
                        "actions": f["actions"],
                    }
                annotations["data"].append(
                    {"scene_name": scene_name, "state_table": light, "root": root_id}
                )
        os.makedirs(os.path.dirname(os.path.abspath(ann_path)), exist_ok=True)
        with open(ann_path, "w") as f:
            json.dump(annotations, f)
        return annotations
