"""Config serialization: the tag + kwargs round trip.

Port of ``diffsci_tpu/config.py``: a registry of constructors by tag, so
that a component registered here rebuilds from a plain-JSON description
``{"tag": ..., "extra_args": {...}, "factory": optional classmethod}``.
The port keeps its own registry; a description is plain data and reads
the same in either package.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Callable

_REGISTRY: dict[str, Callable[..., Any]] = {}


def register(tag: str):
    """Class decorator registering a constructor under ``tag``."""
    def deco(cls):
        _REGISTRY[tag] = cls
        cls.tag = tag
        return cls
    return deco


def build(description: dict[str, Any]):
    """Rebuild a registered component from ``{"tag": ..., "extra_args":
    ...}``, through ``factory`` (a classmethod name) when given."""
    tag = description["tag"]
    if tag not in _REGISTRY:
        raise ValueError(f"unknown config tag: {tag!r}")
    ctor = _REGISTRY[tag]
    factory = description.get("factory")
    if factory is not None:
        ctor = getattr(ctor, factory)
    return ctor(**description.get("extra_args", {}))


def save_description(description: dict[str, Any],
                     path: str | pathlib.Path) -> None:
    pathlib.Path(path).write_text(json.dumps(description, indent=2))


def load_description(path: str | pathlib.Path) -> dict[str, Any]:
    return json.loads(pathlib.Path(path).read_text())
