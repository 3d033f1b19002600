"""Device-resident policy path storage (a frozen copy of the port's module;
counterpart of interactron_tpu/utils/device_path_storage.py).

The reference's PathStorage is a host-side prefix tree over 4-action paths
keyed by episode. With 4 actions and depth 4 it flattens into 1+4+16+64 = 85
prefix nodes per episode uid:

    node(d=0) = 0
    node(d=1) = 1  + a0
    node(d=2) = 5  + 4*a0 + a1
    node(d=3) = 21 + 16*a0 + 4*a1 + a2

`update_and_label` keeps the lowest reward seen at each prefix with the
action taken there, and returns the stored best actions after the update
(the reference's add-then-label order).

State: {"cost": (N, 85) fp32 (1e30 at init), "action": (N, 85) int64}.
"""

import torch

NUM_NODES = 85
_INF = 1e30


def init_path_state(num_episodes, device):
    """Empty state of `num_episodes` episodes on `device` (no default: the
    state lives beside the model that updates it)."""
    return {
        "cost": torch.full((num_episodes, NUM_NODES), _INF, dtype=torch.float32, device=device),
        "action": torch.zeros((num_episodes, NUM_NODES), dtype=torch.int64, device=device),
    }


def _prefix_nodes(actions):
    """actions (..., 4) -> (..., 4) node indices of the path's prefixes."""
    a0, a1, a2 = actions[..., 0], actions[..., 1], actions[..., 2]
    return torch.stack([torch.zeros_like(a0), 1 + a0, 5 + 4 * a0 + a1,
                        21 + 16 * a0 + 4 * a1 + a2], dim=-1)


def update_and_label(state, uids, actions, rewards):
    """add_path + get_label for a batch of episodes with distinct uids:
    uids (B,), actions (B, 4), rewards (B,) -> (new state, labels (B, 4))."""
    actions = actions.long()
    nodes = _prefix_nodes(actions)
    rows = uids.long()[:, None].expand_as(nodes)
    costs = state["cost"][rows, nodes]
    acts = state["action"][rows, nodes]
    better = rewards[:, None].float() < costs
    new_cost = torch.where(better, rewards[:, None].float(), costs)
    new_action = torch.where(better, actions, acts)
    cost = state["cost"].clone()
    action = state["action"].clone()
    cost[rows, nodes] = new_cost
    action[rows, nodes] = new_action
    return {"cost": cost, "action": action}, new_action
