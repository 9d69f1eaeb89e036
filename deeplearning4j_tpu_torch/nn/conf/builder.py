"""NeuralNetConfiguration / MultiLayerConfiguration builders: counterpart
of ``deeplearning4j_tpu/nn/conf/builder.py`` for the ported layers.

The fluent builder with the same names (``NeuralNetConfiguration
.builder().seed(...).updater(...).list().layer(...).setInputType(...)
.build()``), global defaults cloned into the layers, ``n_in`` inferred
from the input type, truncated-BPTT settings, and the JSON round-trip
(``to_json`` / ``from_json``) that reads what the JAX side writes.

Not ported: preprocessors (no ported layer changes the representation;
a configuration that carries one raises), and ``precision(...)`` with a
mixed policy (``nn/precision.py`` comes with ROADMAP item A2), which
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, DenseLayer, Layer, RnnOutputLayer)

#: ported layers that consume sequence [N, T, F] input
_RNN_LAYERS = (LSTM, RnnOutputLayer)


def _check_precision(policy, dtype: str) -> None:
    """Only the identity policies are ported: None, or "float32" with a
    float32 ``dtype``."""
    if policy is None:
        return
    if policy == "float32" and dtype == "float32":
        return
    raise NotImplementedError(
        f"precision policy {policy!r} is not ported to "
        f"deeplearning4j_tpu_torch yet (nn/precision.py, ROADMAP.md A2); "
        f"use dataType(...) for a single-dtype network")


@serializable
@dataclasses.dataclass
class MultiLayerConfiguration:
    """Built, fully resolved network config (every ``n_in`` known)."""

    layers: List[Any] = dataclasses.field(default_factory=list)
    seed: int = 12345
    updater: Any = dataclasses.field(default_factory=lambda: Sgd())
    weight_init: str = "xavier"
    l1: float = 0.0
    l2: float = 0.0
    dtype: str = "float32"
    precision: Optional[Any] = None
    input_type: Optional[InputType] = None
    #: layer index -> preprocessor tag; none of the ported layers needs one
    preprocessors: Dict = dataclasses.field(default_factory=dict)
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    tbptt_fwd_length: int = 0
    tbptt_back_length: int = 0

    def __post_init__(self):
        self.preprocessors = {int(k): v for k, v in self.preprocessors.items()}
        if self.preprocessors:
            raise NotImplementedError(
                f"input preprocessors {self.preprocessors} are not ported to "
                f"deeplearning4j_tpu_torch yet")
        _check_precision(self.precision, self.dtype)

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        cfg = serde.from_json(s)
        if not isinstance(cfg, MultiLayerConfiguration):
            raise ValueError(f"not a MultiLayerConfiguration: "
                             f"{type(cfg).__name__}")
        return cfg


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()...``."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._seed = 12345
        self._updater: IUpdater = Sgd()
        self._weight_init = "xavier"
        self._l1 = 0.0
        self._l2 = 0.0
        self._dtype = "float32"
        self._precision = None
        self._activation = None
        self._grad_norm = None
        self._grad_norm_threshold = 1.0

    def seed(self, s: int) -> "Builder":
        self._seed = int(s)
        return self

    def updater(self, u: IUpdater) -> "Builder":
        self._updater = u
        return self

    def weightInit(self, w) -> "Builder":
        self._weight_init = w.value if hasattr(w, "value") else str(w)
        return self

    def activation(self, a) -> "Builder":
        self._activation = a.value if hasattr(a, "value") else str(a)
        return self

    def l1(self, v: float) -> "Builder":
        self._l1 = float(v)
        return self

    def l2(self, v: float) -> "Builder":
        self._l2 = float(v)
        return self

    def dataType(self, dt) -> "Builder":
        self._dtype = dt.value if hasattr(dt, "value") else str(dt)
        return self

    def precision(self, policy) -> "Builder":
        """Only None (and "float32" on a float32 network) are ported; a
        mixed policy raises ``NotImplementedError``."""
        _check_precision(policy, self._dtype)
        self._precision = policy
        return self

    def gradientNormalization(self, mode: str,
                              threshold: float = 1.0) -> "Builder":
        self._grad_norm = mode
        self._grad_norm_threshold = threshold
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self)


class ListBuilder:
    """Reference: NeuralNetConfiguration.ListBuilder."""

    def __init__(self, parent: Builder):
        self._p = parent
        self._layers: List[Layer] = []
        self._input_type: Optional[InputType] = None
        self._backprop_type = None   # None = infer from the tBPTT lengths
        self._tbptt_fwd = 0
        self._tbptt_back = 0

    def layer(self, *args) -> "ListBuilder":
        """``layer(conf)`` or ``layer(index, conf)``."""
        self._layers.append(args[-1])
        return self

    def setInputType(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def backpropType(self, bp_type: str) -> "ListBuilder":
        """'Standard' or 'TruncatedBPTT'."""
        self._backprop_type = str(bp_type)
        return self

    def tBPTTForwardLength(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = int(n)
        return self

    def tBPTTBackwardLength(self, n: int) -> "ListBuilder":
        self._tbptt_back = int(n)
        return self

    def tBPTTLength(self, n: int) -> "ListBuilder":
        return self.tBPTTForwardLength(n).tBPTTBackwardLength(n)

    def build(self) -> MultiLayerConfiguration:
        """Clone the global defaults into the layers, infer each
        ``n_in`` from the input type, resolve the tBPTT lengths."""
        p = self._p
        layers = self._layers
        if not layers:
            raise ValueError("No layers added")
        it = self._input_type
        for i, layer in enumerate(layers):
            if layer.activation is None and p._activation is not None:
                layer.activation = p._activation
            if layer.weight_init is None:
                layer.weight_init = p._weight_init
            if layer.l1 is None:
                layer.l1 = p._l1
            if layer.l2 is None:
                layer.l2 = p._l2
            if it is None:
                continue  # no shape inference: the user set n_in
            if isinstance(layer, _RNN_LAYERS) and it.kind != "recurrent":
                raise ValueError(
                    f"Layer {i} ({type(layer).__name__}) needs recurrent "
                    f"input, got {it.kind}")
            if isinstance(layer, DenseLayer) and it.kind not in (
                    "feedforward", "recurrent"):
                raise NotImplementedError(
                    f"Layer {i} ({type(layer).__name__}) on {it.kind} input "
                    f"needs a preprocessor, not ported yet")
            if getattr(layer, "n_in", 0) in (0, None):
                layer.n_in = it.size
            it = layer.output_type(it)

        # explicit backpropType wins; a length without backpropType
        # implies TruncatedBPTT; TruncatedBPTT without a length takes 20
        if self._backprop_type == "Standard":
            tbptt_fwd = 0
        elif self._backprop_type == "TruncatedBPTT":
            tbptt_fwd = self._tbptt_fwd or 20
        else:
            tbptt_fwd = self._tbptt_fwd
        tbptt_back = self._tbptt_back or tbptt_fwd
        if tbptt_fwd and tbptt_back != tbptt_fwd:
            warnings.warn(
                "tBPTTBackwardLength != tBPTTForwardLength is not supported "
                f"(the backward length follows the segment length "
                f"{tbptt_fwd}); configured {tbptt_back} is recorded but has "
                "no effect", stacklevel=2)

        return MultiLayerConfiguration(
            layers=layers, seed=p._seed, updater=p._updater,
            weight_init=p._weight_init, l1=p._l1, l2=p._l2, dtype=p._dtype,
            precision=p._precision, input_type=self._input_type,
            preprocessors={}, gradient_normalization=p._grad_norm,
            gradient_normalization_threshold=p._grad_norm_threshold,
            tbptt_fwd_length=tbptt_fwd, tbptt_back_length=tbptt_back)


__all__ = ["MultiLayerConfiguration", "NeuralNetConfiguration", "Builder",
           "ListBuilder"]
