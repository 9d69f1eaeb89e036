"""``MultiLayerNetwork`` (the ported subset)."""

from deeplearning4j_tpu_torch.nn.multilayer.network import MultiLayerNetwork

__all__ = ["MultiLayerNetwork"]
