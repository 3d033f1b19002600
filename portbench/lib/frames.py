"""The served traffic's frames: a pool of episodes, each a grid of states
whose frames are drawn like the synthetic writer's JPEGs (colored
rectangles on grey, 1 to `max_det` a frame) and ImageNet-normalised in
memory, with the writer's action table: action a from state i leads to
state (7 i + 3 a + 1) mod n_states. An episode starts at state 0."""

import numpy as np

from portbench.lib.synthetic import _COLORS

MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def successors(n_states, n_actions):
    """(n_states, n_actions) next state of each state under each action."""
    s = np.arange(n_states)[:, None]
    a = np.arange(n_actions)[None, :]
    return (s * 7 + 3 * a + 1) % n_states


def state_grid(seed, episodes, n_states, size, max_det=10, n_categories=12):
    """(episodes, n_states, size, size, 3) float32 normalised frames."""
    rng = np.random.RandomState(seed % 2**32)
    grid = np.empty((episodes, n_states, size, size, 3), np.float32)
    img = np.empty((size, size, 3), np.float32)
    for e in range(episodes):
        for s in range(n_states):
            img[:] = 230.0
            for _ in range(int(rng.randint(1, max_det + 1))):
                cat = int(rng.randint(0, n_categories))
                w = int(rng.randint(size // 10, size // 3))
                h = int(rng.randint(size // 10, size // 3))
                x = int(rng.randint(0, size - w))
                y = int(rng.randint(0, size - h))
                img[y:y + h + 1, x:x + w + 1] = _COLORS[cat % len(_COLORS)]
            grid[e, s] = (img / 255.0 - MEAN) / STD
    return grid
