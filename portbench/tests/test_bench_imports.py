"""The import check, and what a run does without a card."""

import json
import os
import subprocess
import sys

from portbench.lib import bench


def test_forbidden_modules_by_whole_top_level_name():
    mods = ["interactron_tpu_torch", "interactron_tpu_torch.ops.flash_attention", "jaxtyping",
            "flaxen", "torch", "interactron_tpu_tools"]
    assert bench.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "interactron_tpu",
           "interactron_tpu.ops.attention"]
    assert bench.forbidden_modules(mods + bad) == sorted(bad)


def test_a_tiny_run_loads_no_jax():
    """A whole tiny train and serve drive in a fresh process: no module of
    JAX, flax or the JAX package is loaded."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {bench.ROOT!r})\n"
        "from portbench.tests.tiny_cell import make_run\n"
        "from portbench.lib import bench\n"
        "for kind in ('train', 'single'):\n"
        "    bench.execute(make_run(kind, trace=True))\n"
        "print(json.dumps(bench.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_means_no_result(tmp_path):
    """Without CUDA the run exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(bench.ROOT, "portbench", "run.py"),
                          "--workload", "interactron.serve.single", "--seed", "2147483800",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode != 0
    assert not any(l.startswith("{") for l in out.stdout.splitlines())
