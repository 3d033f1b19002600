#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The port (`interactron_tpu_torch`) is the
program under test; nothing here imports JAX or the JAX package. Build and
kernel caches stay inside the checkout, under build/.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

from portbench.lib import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:]))
