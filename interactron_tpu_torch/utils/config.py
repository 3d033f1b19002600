"""YAML -> attribute-access config tree (own copy of the loader in
interactron_tpu/utils/config.py): nested sections become attributes and
numeric strings coerce to int/float."""

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
