"""Guards on the port's boundaries: it imports nothing of JAX or of the JAX
package and reads no file under interactron_tpu/ (every module imported,
one episode loaded), and an entry point asked for CUDA on a host without it
raises instead of running on the CPU."""

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
from interactron_tpu_torch.data.episode_dataset import InteractiveEpisodeDataset
from interactron_tpu_torch.data.synthetic import make_synthetic_dataset
with tempfile.TemporaryDirectory() as tmp:
    ds = InteractiveEpisodeDataset(*make_synthetic_dataset(tmp, 1, 5, 32), "test", resolution=32)
    ds.reset()
bad = [m for m in sys.modules
       if m in ("jax", "flax", "interactron_tpu")
       or m.startswith(("jax.", "flax.", "interactron_tpu."))]
assert not bad, bad
for mod in ("tasks.interactron", "data.transforms", "ops.nms", "engine.ap", "utils.checkpoint",
            "utils.logging", "utils.config", "utils.constants"):
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


@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_point_without_cuda_raises(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InteractronTask(Config(tiny_config().to_dict()), device=device)
