"""The FLOP counts stored in the configuration files recount to the same
numbers, and the fast weights' conv work that the counter attributes is
the analytic 2·N·Ho·Wo·k²·Ci·Co of every forward, input gradient and
kernel gradient the path takes."""

import json
import os

import pytest

from portbench.lib import bench, flops
from portbench.tests.tiny_cell import IMG, TINY


@pytest.mark.parametrize("name", ["interactron", "interactron_scaled"])
def test_stored_counts_recount(name):
    with open(os.path.join(bench.ROOT, "portbench/configs", name + ".json")) as f:
        cfg = json.load(f)
    assert flops.count(cfg["config"]) == cfg["flops"]


def _conv(n, hw_out, k, ci, co):
    return 2.0 * n * hw_out * k * k * ci * co


def test_fast_weight_conv_work_at_a_cut_size():
    """The tiny backbone's two trainable 5x5 stride-4 convs (3 -> 32 -> 64
    channels; 32 px -> 8x8 -> 2x2) on a served episode: next_action's
    forwards on 1 + 2 + 3 + 4 frames, adapt's forward on 5 frames with both
    kernel gradients and conv2's input gradient (conv1's input is the
    frames), and the frame-0 detect's forward: every first-order op is
    2·N·Ho·Wo·k²·Ci·Co. The train step adds the double backward's ops, which
    the counter takes at their own geometry (see lib/flops.py)."""
    c1 = lambda n: _conv(n, 8 * 8, 5, 3, 32)
    c2 = lambda n: _conv(n, 2 * 2, 5, 32, 64)
    got = flops.count(TINY)
    serve = (c1(10 + 5 + 1) + c2(10 + 5 + 1)) + (c1(5) + c2(5)) + c2(5)
    assert got["fwconv_serve_episode"] == pytest.approx(serve)
    # the train step's passes: inner, supervisor (5 frames), detector (1),
    # each forward with its first-order gradients, then the second order
    first_order = 2 * (c1(5) * 2 + c2(5) * 3) + c1(1) * 2 + c2(1) * 3
    assert got["fwconv_train_episode"] > first_order
