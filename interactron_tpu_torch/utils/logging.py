"""Metric logging (counterpart of interactron_tpu/utils/logging.py): scalars
buffer per epoch, and `log_values` appends their means to
`{log_dir}/metrics.jsonl` as one record {"step", "time", name: mean, ...},
the same record the JAX package writes.

The JAX package also writes TensorBoard events when it can import a
writer; the port writes none (TensorBoard is not a dependency of the
port), so `metrics.jsonl` is its only log.
"""

import json
import os
import time


class MetricLogger:
    def __init__(self, log_dir):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._buffer = {}
        self._step = 0
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_value(self, name, value):
        self._buffer.setdefault(name, []).append(float(value))

    def log_values(self):
        """Write the buffered means as one record, clear the buffer, and
        return the means."""
        means = {k: sum(v) / len(v) for k, v in self._buffer.items() if v}
        self._jsonl.write(json.dumps({"step": self._step, "time": time.time(), **means}) + "\n")
        self._jsonl.flush()
        self._buffer = {}
        self._step += 1
        return means

    def close(self):
        self._jsonl.close()
