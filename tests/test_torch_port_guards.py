"""Guards on the port's boundaries: it imports nothing of JAX, flax,
msgpack or the JAX package and reads no file under interactron_tpu/ (every
module imported, one episode loaded; and no import statement of those in
any of its sources, chip_smoke.py or dp_smoke.py, at any depth of a
function), and an
entry point asked for CUDA on a host without it raises instead of running
on the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from interactron_tpu_torch.tasks import InteractronTask
from interactron_tpu_torch.utils.config import Config
from tiny_config import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import os, sys, tempfile
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0])) if event == "open" else None)
import interactron_tpu_torch.tasks, interactron_tpu_torch.utils.from_jax
import interactron_tpu_torch.ops.cuda_build, interactron_tpu_torch.ops.flash_attention
import interactron_tpu_torch.train, interactron_tpu_torch.evaluate
import interactron_tpu_torch.engine.evaluator, interactron_tpu_torch.engine.trainer
import pkgutil, importlib, interactron_tpu_torch
for info in pkgutil.walk_packages(interactron_tpu_torch.__path__, "interactron_tpu_torch."):
    importlib.import_module(info.name)
import chip_smoke
from interactron_tpu_torch.data.episode_dataset import InteractiveEpisodeDataset
from interactron_tpu_torch.data.synthetic import make_synthetic_dataset
with tempfile.TemporaryDirectory() as tmp:
    ds = InteractiveEpisodeDataset(*make_synthetic_dataset(tmp, 1, 5, 32), "test", resolution=32)
    ds.reset()
bad = [m for m in sys.modules
       if m in ("jax", "flax", "msgpack", "interactron_tpu")
       or m.startswith(("jax.", "flax.", "msgpack.", "interactron_tpu."))]
assert not bad, bad
for mod in ("tasks.interactron", "data.transforms", "ops.nms", "engine.ap", "utils.checkpoint",
            "utils.logging", "utils.config", "utils.constants", "utils.flax_msgpack",
            "utils.convert_weights", "parallel.mesh", "utils.profiling", "utils.optim"):
    assert "interactron_tpu_torch." + mod in sys.modules, mod
jax_pkg = os.path.join(os.getcwd(), "interactron_tpu") + os.sep
read = [p for p in opened if os.path.abspath(p).startswith(jax_pkg)]
assert not read, read
assert any(p.endswith(os.path.join("interactron_tpu_torch", "data", "vocabulary.json"))
           for p in opened)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    subprocess.run([sys.executable, "-c", _CHECK], check=True, cwd=REPO, timeout=120,
                   env=dict(os.environ, PYTHONPATH=REPO))


_BANNED = ("jax", "flax", "msgpack", "interactron_tpu")


def _sources():
    pkg = os.path.join(REPO, "interactron_tpu_torch")
    for root, _, files in os.walk(pkg):
        yield from (os.path.join(root, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "dp_smoke.py")


def test_no_source_imports_jax_flax_msgpack_or_the_jax_package():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [(os.path.relpath(path, REPO), n) for n in names
                    if n.split(".")[0] in _BANNED]
    assert not bad, bad


@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_point_without_cuda_raises(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InteractronTask(Config(tiny_config().to_dict()), device=device)
