"""Training entry point of the port (counterpart of the root train.py):
seed 42, build the task, its evaluator and trainer from the YAML, train.

    python -m interactron_tpu_torch.train --config_file configs/interactron.yaml

Runs on CUDA unless `--device cpu` is given, and raises without CUDA.
"""

import random

import numpy as np

from interactron_tpu_torch.utils.config import (
    build_evaluator,
    build_model,
    build_trainer,
    get_args,
    get_config,
)


def train(argv=None):
    args = get_args(argv)
    random.seed(42)
    np.random.seed(42)
    config = get_config(args.config_file)
    task = build_model(config, device=args.device).init(42)
    evaluator = build_evaluator(task, config, load_checkpoint=False)
    trainer = build_trainer(task, config, evaluator=evaluator)
    trainer.train()
    return trainer


if __name__ == "__main__":
    train()
