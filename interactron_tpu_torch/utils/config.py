"""YAML -> attribute-access config tree, command-line arguments and the
component factories (own copy of interactron_tpu/utils/config.py): nested
sections become attributes and numeric strings coerce to int/float. The
factories build the rows the port has: model and trainer `interactron`,
evaluators `random_policy_evaluator` and `interactive_evaluator`; any other
row raises NotImplementedError."""

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


_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue 1 item 8)"


def build_model(config, device=None):
    """The task of MODEL.TYPE on `device` (CUDA by default, as
    tasks/base.py::resolve_device); its weights are drawn by `init`."""
    t = config.MODEL.TYPE
    if t != "interactron":
        raise NotImplementedError(f"model type {t!r} {_NOT_PORTED}")
    from interactron_tpu_torch.tasks import InteractronTask

    return InteractronTask(config, device=device)


def build_trainer(task, config, evaluator=None):
    """The Trainer of TRAINER.TYPE; it trains `task` on the task's device."""
    t = config.TRAINER.TYPE
    if t != "interactron":
        raise NotImplementedError(f"trainer type {t!r} {_NOT_PORTED}")
    from interactron_tpu_torch.engine.trainer import Trainer

    return Trainer(task, config, evaluator=evaluator)


def build_evaluator(task, config, load_checkpoint=False):
    """The evaluator of EVALUATOR.TYPE over DATASET.TEST."""
    from interactron_tpu_torch.engine.evaluator import InteractiveEvaluator, RandomPolicyEvaluator

    classes = {"random_policy_evaluator": RandomPolicyEvaluator,
               "interactive_evaluator": InteractiveEvaluator}
    t = config.EVALUATOR.TYPE
    if t not in classes:
        raise NotImplementedError(f"evaluator type {t!r} {_NOT_PORTED}")
    return classes[t](task, config, load_checkpoint=load_checkpoint)
