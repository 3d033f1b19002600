"""The plain reference agrees with the port at a tiny size on the CPU,
through the harness's own drivers: the same weights, inputs, frame draws,
dropout masks, matching and path state give the same losses, gradients,
steps, actions and predictions. Only this test imports both."""

import ast
import os

import pytest

from portbench.lib import bench
from portbench.tests.tiny_cell import make_run


@pytest.mark.parametrize("kind", ["train", "single", "lockstep"])
def test_reference_matches_port_fp32(kind):
    run = make_run(kind, seed=5)
    result, numbers = bench.execute(run)
    assert result["correct"]
    # fp32 against fp32 on the same plain kernels: the same arithmetic up to
    # the batched layout's summation order; g_err is in units of what
    # rounding the weights to bf16 moves the reference's gradient
    for name, value, _ in numbers:
        assert value <= (1e-3 if name == "g_err" else 1e-5), (name, value)
    assert result["attempted"] > 0 and result["failed"] == 0


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(bench.ROOT, "portbench", "reference")
    for fname in os.listdir(ref):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(ref, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("interactron_tpu_torch", "interactron_tpu", "jax",
                                               "jaxlib", "flax"), (fname, n)
