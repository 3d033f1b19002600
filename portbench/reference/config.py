"""Attribute access over a nested config dict, with numeric strings read as
numbers (as the port's and the JAX package's YAML configs are read)."""


def _coerce(v):
    if isinstance(v, str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
    return v


class Config:
    def __init__(self, d):
        self._raw = d
        for k, v in d.items():
            setattr(self, k, Config(v) if isinstance(v, dict) else _coerce(v))

    def get(self, key, default=None):
        return getattr(self, key, default)

    def to_dict(self):
        return self._raw
