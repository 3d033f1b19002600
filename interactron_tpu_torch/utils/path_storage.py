"""Host-side policy supervision storage (own copy of
interactron_tpu/utils/path_storage.py): the host twin of the device tree in
utils/device_path_storage.py, which the tasks use.

A prefix tree over 4-action paths storing the best (lowest) ground-truth
adaptation loss seen at each node; `get_label` returns, for each prefix of a
path, the first action of the best path through that node: the supervision
target for the fusion policy head. A tie keeps the path seen first
(`add_path` compares with a strict <).

The bank is keyed by episode uid and updates its episodes in order, the
serial order the device tree reproduces.
"""

import numpy as np


class _Node:
    __slots__ = ("cost", "action", "edges")

    def __init__(self):
        self.cost = float("inf")
        self.action = 0
        self.edges = {}


class PathStorage:
    def __init__(self):
        self.root = _Node()

    def add_path(self, path, cost):
        curr = self.root
        for a in path:
            a = int(a)
            if cost < curr.cost:
                curr.cost = cost
                curr.action = a
            if a not in curr.edges:
                curr.edges[a] = _Node()
            curr = curr.edges[a]

    def get_label(self, path):
        labels = []
        curr = self.root
        for a in path:
            labels.append(curr.action)
            curr = curr.edges[int(a)]
        return labels


class PathStorageBank:
    """uid -> PathStorage."""

    def __init__(self):
        self.storages = {}

    def update_and_label(self, rewards, actions, uids):
        """For each episode (in order) add its path with its reward and
        return the best-path labels.

        Args:
          rewards: (mb,) float32, actions: (mb, 4) int, uids: (mb,) int.
        Returns:
          (mb, 4) int32 labels.
        """
        rewards = np.asarray(rewards)
        actions = np.asarray(actions)
        uids = np.asarray(uids)
        out = np.zeros_like(actions, dtype=np.int32)
        for i in range(len(uids)):
            uid = int(uids[i])
            store = self.storages.setdefault(uid, PathStorage())
            path = actions[i, :4]
            store.add_path(path, float(rewards[i]))
            out[i] = np.asarray(store.get_label(path), np.int32)
        return out
