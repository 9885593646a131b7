"""Hierarchical hyper-parameter namespaces loaded from YAML.

The port's own copy of the parts of ``vae_gslm_tpu/hparams/hp.py`` that
it uses (that package imports JAX, so the port may not import it).
YAML files and dicts become nested attribute namespaces, and consumers
assert required keys with ``check_arg_in_hparams`` at construction
time.  Both copies parse every config to the same dict
(``tests/test_torch_config.py``).
"""
from __future__ import annotations

from typing import Any, Mapping

import yaml


class Hparams:
    """A recursive attribute namespace over a dict.

    Nested mappings become nested ``Hparams``. Lists are kept as lists
    (with nested dict elements also wrapped).
    """

    def __init__(self, **kwargs: Any) -> None:
        for key, val in kwargs.items():
            object.__setattr__(self, key, _wrap(val))

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "Hparams":
        return cls(**data)

    @classmethod
    def from_yamlfile(cls, yamlfile: str) -> "Hparams":
        with open(yamlfile, "r") as f:
            data = yaml.safe_load(f)
        return cls.from_dict(data or {})

    @classmethod
    def from_yaml(cls, yaml_s: str) -> "Hparams":
        return cls.from_dict(yaml.safe_load(yaml_s) or {})

    # -- the reference API surface ----------------------------------------
    def check_arg_in_hparams(self, *args: str) -> None:
        for arg in args:
            if arg not in self.__dict__:
                raise ValueError(
                    f"{arg} not specified in the hyperparameter: {self}"
                )

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def has(self, key: str) -> bool:
        return key in self.__dict__

    def to_dict(self) -> dict:
        return _unwrap(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.dump(self.to_dict(), f)

    # -- dunder plumbing ---------------------------------------------------
    def __setattr__(self, key: str, value: Any) -> None:
        object.__setattr__(self, key, _wrap(value))

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Hparams):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __repr__(self) -> str:
        return f"Hparams({self.to_dict()!r})"

    def __getattr__(self, key: str) -> Any:
        # Only called when normal lookup fails.
        raise AttributeError(
            f"Hparams has no key {key!r}; available: "
            f"{sorted(self.__dict__.keys())}"
        )


def _wrap(val: Any) -> Any:
    if isinstance(val, Hparams):
        return val
    if isinstance(val, Mapping):
        return Hparams(**val)
    if isinstance(val, (list, tuple)):
        return [_wrap(v) for v in val]
    return val


def _unwrap(val: Any) -> Any:
    if isinstance(val, Hparams):
        return {k: _unwrap(v) for k, v in val.__dict__.items()}
    if isinstance(val, (list, tuple)):
        return [_unwrap(v) for v in val]
    return val
