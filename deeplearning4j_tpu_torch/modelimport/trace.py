"""Mapper-dispatch accounting of the importers: counterpart of
``deeplearning4j_tpu/modelimport/trace.py`` (:25-51).

Every mapper dispatched on a real node during an import records
``"<framework>:<name>"`` (``"tf:Conv2D"``) in an in-process set, as
``ops/registry.py`` records executed ops. The port's set is its own: it
writes no file and reads no environment variable.
"""

from __future__ import annotations

from typing import Set

_DRIVEN: Set[str] = set()


def record(framework: str, name: str) -> None:
    """Record that the mapper for ``name`` ran on a node of an import."""
    _DRIVEN.add(f"{framework}:{name}")


def driven_mappers() -> Set[str]:
    """The mappers driven so far in this process."""
    return set(_DRIVEN)
