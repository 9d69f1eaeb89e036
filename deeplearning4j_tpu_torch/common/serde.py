"""Config JSON serde: a copy of ``deeplearning4j_tpu/common/serde.py``.

Every serializable config is a dataclass registered here; polymorphism
is encoded as ``{"@class": <registered name>, ...fields}``, so the port
reads the ``configuration.json`` that the JAX side writes, and
``from_json(to_json(cfg)) == cfg`` for every registered config.

A tag whose class the JAX package registers but the port has not ported
yet raises ``NotImplementedError`` naming the class.
"""

from __future__ import annotations

import dataclasses
import enum as _enum
import json
from typing import Any, Dict

_CLASSES: Dict[str, type] = {}


def serializable(cls=None):
    """Class decorator: register a dataclass for polymorphic JSON serde."""

    def wrap(c):
        if not dataclasses.is_dataclass(c):
            raise TypeError(f"@serializable requires a dataclass: {c}")
        _CLASSES[c.__name__] = c
        return c

    return wrap(cls) if cls is not None else wrap


def registered() -> Dict[str, type]:
    """The registered classes by name (a copy)."""
    return dict(_CLASSES)


def to_dict(obj: Any) -> Any:
    """Recursively convert registered dataclasses to tagged dicts."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if name not in _CLASSES:
            raise TypeError(
                f"{name} is not JSON-serializable (not @serializable-"
                "registered); networks containing it cannot round-trip "
                "to_json()")
        d = {"@class": name}
        for f in dataclasses.fields(obj):
            d[f.name] = to_dict(getattr(obj, f.name))
        return d
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, _enum.Enum):
        return obj.value
    return obj


def from_dict(d: Any) -> Any:
    """Inverse of :func:`to_dict`: rebuild registered dataclasses from
    their tags. Extra keys a class does not know are dropped (forward
    compatibility, as in the JAX copy)."""
    if isinstance(d, dict):
        if "@class" in d:
            name = d["@class"]
            if name not in _CLASSES:
                raise NotImplementedError(
                    f"{name} is not ported to deeplearning4j_tpu_torch yet "
                    f"(the configuration names a class this package does "
                    f"not register; see ROADMAP.md)")
            cls = _CLASSES[name]
            field_names = {f.name for f in dataclasses.fields(cls)}
            kwargs = {k: from_dict(v) for k, v in d.items()
                      if k != "@class" and k in field_names}
            return cls(**kwargs)
        return {k: from_dict(v) for k, v in d.items()}
    if isinstance(d, list):
        return [from_dict(v) for v in d]
    return d


def to_json(obj: Any, indent: int | None = 2) -> str:
    return json.dumps(to_dict(obj), indent=indent)


def from_json(s: str) -> Any:
    return from_dict(json.loads(s))
