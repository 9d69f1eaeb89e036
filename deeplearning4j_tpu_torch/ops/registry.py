"""Op registry: counterpart of ``deeplearning4j_tpu/ops/registry.py``
(:28-73). Ops are plain functions on torch tensors, registered by name
and looked up by name (``Nd4j.exec``, ``SameDiff`` graphs).

This is the port's own dictionary: nothing here registers into the JAX
package's registry. Every dispatch records the op's name in an
in-process set (:func:`executed_ops`).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Set

_REGISTRY: Dict[str, Callable] = {}
_EXECUTED: Set[str] = set()


def register_op(name: str):
    """Register ``fn`` under ``name``; returns the dispatch wrapper, which
    records execution, so a direct call counts like a dispatch by name."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"op already registered: {name}")

        @functools.wraps(fn)
        def dispatch(*args, **kwargs):
            _EXECUTED.add(name)
            return fn(*args, **kwargs)

        _REGISTRY[name] = dispatch
        return dispatch

    return deco


def get_op(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"Unknown op '{name}'. Registered: {sorted(_REGISTRY)[:20]}..."
        ) from None


def list_ops() -> list[str]:
    return sorted(_REGISTRY)


def has_op(name: str) -> bool:
    return name in _REGISTRY


def executed_ops() -> Set[str]:
    """Ops dispatched so far in this process."""
    return set(_EXECUTED)
