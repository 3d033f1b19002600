"""YAML -> attribute-access config tree, command-line arguments and the
component factories (own copy of interactron_tpu/utils/config.py): nested
sections become attributes and numeric strings coerce to int/float. The
factories build every row of the JAX package's: models `detr`,
`detr_multiframe`, `interactron_random` and `interactron`, trainers
`interactron`, `interactron_random` and `direct_supervision`, evaluators
`random_policy_evaluator` and `interactive_evaluator`; any other TYPE
raises ValueError."""

import argparse
import os

import yaml


def _coerce(v):
    if isinstance(v, str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
    return v


class Config:
    """Recursive attribute-object over a YAML dict."""

    def __init__(self, d):
        self._raw = d
        for k, v in d.items():
            setattr(self, k, Config(v) if isinstance(v, dict) else _coerce(v))

    def get(self, key, default=None):
        return getattr(self, key, default)

    def to_dict(self):
        return self._raw


def get_config(path):
    if not os.path.exists(path):
        raise FileNotFoundError(f"Config file {path} does not exist")
    with open(path) as f:
        return Config(yaml.safe_load(f))


def get_args(argv=None):
    """The entry points' arguments: --config_file, and --device (CUDA by
    default; `cpu` runs the plain versions of the kernels)."""
    parser = argparse.ArgumentParser(description="interactron-tpu, PyTorch/CUDA port")
    parser.add_argument("--config_file", type=str, required=True, help="Path to experiment YAML")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; raises when CUDA is missing)")
    return parser.parse_args(argv)


VALID_MODELS = ("detr", "detr_multiframe", "interactron_random", "interactron")
VALID_TRAINERS = ("interactron", "interactron_random", "direct_supervision")
VALID_EVALUATORS = ("random_policy_evaluator", "interactive_evaluator")


def _check_type(kind, value, valid):
    if value not in valid:
        raise ValueError(f"{kind} type {value!r} not in {valid}")


def build_model(config, device=None):
    """The task of MODEL.TYPE on `device` (CUDA by default, as
    tasks/base.py::resolve_device); its weights are drawn by `init`."""
    t = config.MODEL.TYPE
    _check_type("model", t, VALID_MODELS)
    from interactron_tpu_torch import tasks

    cls = {"detr": tasks.DETRTask, "detr_multiframe": tasks.MultiFrameTask,
           "interactron_random": tasks.InteractronRandomTask,
           "interactron": tasks.InteractronTask}[t]
    return cls(config, device=device)


def build_trainer(task, config, evaluator=None):
    """The Trainer of TRAINER.TYPE; it trains `task` on the task's device."""
    _check_type("trainer", config.TRAINER.TYPE, VALID_TRAINERS)
    from interactron_tpu_torch.engine.trainer import Trainer

    return Trainer(task, config, evaluator=evaluator)


def build_evaluator(task, config, load_checkpoint=False):
    """The evaluator of EVALUATOR.TYPE over DATASET.TEST."""
    from interactron_tpu_torch.engine.evaluator import InteractiveEvaluator, RandomPolicyEvaluator

    t = config.EVALUATOR.TYPE
    _check_type("evaluator", t, VALID_EVALUATORS)
    cls = RandomPolicyEvaluator if t == "random_policy_evaluator" else InteractiveEvaluator
    return cls(task, config, load_checkpoint=load_checkpoint)
