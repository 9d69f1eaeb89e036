"""Model zoo (the ported subset): ``TextGenerationLSTM``."""

from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.textgen_lstm import TextGenerationLSTM

__all__ = ["ZooModel", "TextGenerationLSTM"]
