"""Guards on the port's boundaries: it imports nothing of JAX or of the JAX
package, and an entry point asked for CUDA on a host without it raises
instead of running on the CPU."""

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
import sys
import interactron_tpu_torch.tasks, interactron_tpu_torch.utils.from_jax
import interactron_tpu_torch.ops.cuda_build, interactron_tpu_torch.ops.flash_attention
bad = [m for m in sys.modules
       if m in ("jax", "flax", "interactron_tpu")
       or m.startswith(("jax.", "flax.", "interactron_tpu."))]
assert not bad, bad
assert "interactron_tpu_torch.tasks.interactron" in sys.modules
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    subprocess.run([sys.executable, "-c", _CHECK], check=True, cwd=REPO, timeout=120,
                   env=dict(os.environ, PYTHONPATH=REPO))


@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_point_without_cuda_raises(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InteractronTask(Config(tiny_config().to_dict()), device=device)
