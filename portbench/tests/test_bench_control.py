"""The control: the reference one precision step below the configuration's
bf16 (fp8 e4m3 matmul and convolution operands, per-tensor scales), put
in the program's place, has to come out not correct. On the card at each
cell's own size (`cuda`, run there with `python -m pytest --noconftest
portbench/tests -m cuda`); here its pieces at a tiny size."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.lib import bench
from portbench.lib.precision import Fp8Matmuls, to_fp8
from portbench.tests.tiny_cell import make_run


def test_fp8_rounding():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    q = to_fp8(x)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-3)).median()
    assert 0.005 < float(rel) < 0.07  # 3 mantissa bits
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with Fp8Matmuls():
        c = a @ b
    assert torch.allclose(c, to_fp8(a) @ to_fp8(b))
    assert not torch.allclose(c, a @ b, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("kind", ["train", "single"])
def test_control_reads_above_the_program_at_a_tiny_size(kind):
    def readings(control):
        run = make_run(kind, seed=9, dtype="bfloat16")
        driver = bench.load_module(os.path.join(bench.ROOT, "portbench", "drivers",
                                                run.traffic["driver"] + ".py"), "d")
        if control:
            driver.control(run)
        else:
            driver.setup(run)
            if run.traffic["driver"] == "serve":
                driver.window(run)
        return {n: v for n, v, _ in driver.check(run)}

    prog, ctl = readings(False), readings(True)
    assert any(ctl[n] > 2 * prog[n] for n in prog), (prog, ctl)


CELLS = ["interactron_scaled.train.b16", "interactron.serve.lockstep10"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    out = subprocess.run([sys.executable, os.path.join(bench.ROOT, "portbench", "readings.py"),
                          "--workload", workload, "--seeds", "2147483001", "--mode", "control"],
                         capture_output=True, text=True, timeout=1800, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    with open(os.path.join(bench.ROOT, "portbench", "limits", workload + ".json")) as f:
        limits = json.load(f)
    assert any(line[n] > lim for n, lim in limits.items()), line
