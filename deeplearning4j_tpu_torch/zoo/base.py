"""ZooModel base: counterpart of ``deeplearning4j_tpu/zoo/base.py``."""

from __future__ import annotations


class ZooModel:
    def init(self, device=None):
        """Build and ``init()`` the network on ``device`` (default: the
        CUDA card)."""
        raise NotImplementedError
