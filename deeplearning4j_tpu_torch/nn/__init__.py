"""The layer framework: configurations (``nn.conf``), weight init
(``nn.weights``), ``nn.multilayer.MultiLayerNetwork``,
``nn.graph.ComputationGraph`` and transfer learning
(``nn.transferlearning``: ``FrozenLayer``, ``FrozenLayerWithBackprop``,
``FineTuneConfiguration``, ``TransferLearning.Builder`` /
``GraphBuilder`` and ``TransferLearningHelper``).

Importing the package registers every configuration class with the JSON
serde, the frozen wrappers included, so a configuration that names one
parses wherever it is read."""

from deeplearning4j_tpu_torch.nn.conf import *  # noqa: F401,F403
from deeplearning4j_tpu_torch.nn.conf import __all__ as _conf_all
from deeplearning4j_tpu_torch.nn.transferlearning import (
    FineTuneConfiguration, FrozenLayer, FrozenLayerWithBackprop,
    TransferLearning, TransferLearningGraphBuilder, TransferLearningHelper)

__all__ = list(_conf_all) + [
    "FineTuneConfiguration", "FrozenLayer", "FrozenLayerWithBackprop",
    "TransferLearning", "TransferLearningGraphBuilder",
    "TransferLearningHelper"]
