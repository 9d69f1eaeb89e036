"""ZooModel base: counterpart of ``deeplearning4j_tpu/zoo/base.py``."""

from __future__ import annotations


class ZooModel:
    def init(self, device=None):
        """Build and ``init()`` the network on ``device`` (default: the
        CUDA card)."""
        raise NotImplementedError

    def initPretrained(self, weights_path: str | None = None, device=None):
        """The reference downloads pretrained weights; nothing is
        downloaded here, so a local ModelSerializer zip is required (a
        ``MultiLayerNetwork`` or a ``ComputationGraph``, restored on
        ``device``)."""
        if weights_path is None:
            raise RuntimeError(
                f"{type(self).__name__}.initPretrained(): no network egress "
                "available; pass weights_path to a local ModelSerializer zip")
        from deeplearning4j_tpu_torch.util.model_serializer import (
            ModelSerializer)

        return ModelSerializer.restore(weights_path, device=device)
