"""NeuralNetConfiguration / MultiLayerConfiguration builders: counterpart
of ``deeplearning4j_tpu/nn/conf/builder.py`` for the ported layers.

The fluent builder with the same names (``NeuralNetConfiguration
.builder().seed(...).updater(...).list().layer(...).setInputType(...)
.build()``), global defaults cloned into the layers (``dropOut(keep)``
among them, stored as the drop rate ``1 - keep``), ``n_in`` inferred from
the input type (through the wrappers ``LastTimeStep``, ``Bidirectional``
and ``MaskZeroLayer``; an attention layer's ``n_out`` of 0 becomes its
``n_in``), the input kind each layer family needs checked (images,
volumes, sequences), the preprocessor tags placed where the
representation changes (``"flatten"`` from an image or a volume to a
dense layer, ``"to_conv:H,W,C"`` from a flat image to an image layer;
resolved by :func:`apply_preprocessor`), truncated-BPTT settings, and the
JSON round-trip (``to_json`` / ``from_json``) that reads what the JAX
side writes, the precision policy (``precision(...)``, a preset name or
an ``nn.precision.PrecisionPolicy``) included.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, Sgd
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LSTM, Bidirectional, ConvolutionLayer, DenseLayer, EmbeddingLayer,
    GravesLSTM, LastTimeStep, Layer, LearnedSelfAttentionLayer,
    LocalResponseNormalization, RecurrentAttentionLayer, RnnOutputLayer,
    SelfAttentionLayer, SimpleRnn, SubsamplingLayer, Upsampling2D,
    ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.conf.layers_extra import (
    GRU, CapsuleLayer, CapsuleStrengthLayer, Convolution1D, Convolution3D,
    Cropping1D, Cropping2D, Cropping3D, GravesBidirectionalLSTM,
    LocallyConnected1D, LocallyConnected2D, MaskZeroLayer, PrimaryCapsules,
    SpaceToBatchLayer, SpaceToDepthLayer, Subsampling1DLayer,
    Subsampling3DLayer, Upsampling1D, Upsampling3D, ZeroPadding1DLayer,
    ZeroPadding3DLayer)
# registers PrecisionPolicy with the JSON serde
from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy  # noqa: F401

#: layers that consume image [N, H, W, C] input
_CNN2D_LAYERS = (ConvolutionLayer, SubsamplingLayer, Upsampling2D,
                 ZeroPaddingLayer, LocalResponseNormalization, Cropping2D,
                 SpaceToDepthLayer, SpaceToBatchLayer, LocallyConnected2D,
                 PrimaryCapsules)
#: layers that consume volumetric [N, D, H, W, C] input
_CNN3D_LAYERS = (Convolution3D, Subsampling3DLayer, Upsampling3D,
                 Cropping3D, ZeroPadding3DLayer)
#: layers that consume sequence [N, T, F] input
_RNN_LAYERS = (LSTM, SimpleRnn, GravesLSTM, GRU, GravesBidirectionalLSTM,
               SelfAttentionLayer, LastTimeStep, Bidirectional,
               LearnedSelfAttentionLayer, RecurrentAttentionLayer,
               RnnOutputLayer, Convolution1D, Subsampling1DLayer,
               Upsampling1D, Cropping1D, ZeroPadding1DLayer,
               LocallyConnected1D, MaskZeroLayer, CapsuleLayer,
               CapsuleStrengthLayer)
#: layers whose n_out of 0 the builder sets to their n_in
_ATTENTION_LAYERS = (SelfAttentionLayer, LearnedSelfAttentionLayer,
                     RecurrentAttentionLayer)


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
    #: the precision policy: None (the single-dtype network of ``dtype``),
    #: a preset name ("float32", "mixed_bfloat16", "mixed_float16") or an
    #: ``nn.precision.PrecisionPolicy``
    precision: Optional[Any] = None
    input_type: Optional[InputType] = None
    #: layer index -> preprocessor tag ("flatten" | "to_conv:H,W,C")
    preprocessors: Dict = dataclasses.field(default_factory=dict)
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    tbptt_fwd_length: int = 0
    tbptt_back_length: int = 0

    def __post_init__(self):
        self.preprocessors = {int(k): v for k, v in self.preprocessors.items()}

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
        self._dropout = None
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
        """The precision policy: "float32", "mixed_bfloat16",
        "mixed_float16" or a ``PrecisionPolicy``. Beside ``dataType()``: a
        mixed policy keeps the master parameters in its ``param_dtype``
        (f32) and only the compute drops to bf16 or f16."""
        self._precision = policy
        return self

    def dropOut(self, keep: float) -> "Builder":
        """Input dropout for every layer that sets none: ``keep`` is the
        retain probability, stored as the drop rate ``1 - keep`` (a
        ``keep`` of 0 or less sets none)."""
        self._dropout = 1.0 - float(keep) if keep > 0 else None
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
        ``n_in`` from the input type, place the preprocessors, resolve
        the tBPTT lengths."""
        p = self._p
        layers = self._layers
        if not layers:
            raise ValueError("No layers added")
        preprocessors: Dict[int, str] = {}
        it = self._input_type
        for i, layer in enumerate(layers):
            # a Bidirectional's wrapped layer holds the real configuration
            for lt in [layer] + ([layer.layer]
                                 if isinstance(layer, Bidirectional) else []):
                if lt.activation is None and p._activation is not None:
                    lt.activation = p._activation
                if lt.weight_init is None:
                    lt.weight_init = p._weight_init
                if lt.l1 is None:
                    lt.l1 = p._l1
                if lt.l2 is None:
                    lt.l2 = p._l2
                if lt.dropout is None and p._dropout is not None:
                    lt.dropout = p._dropout
            if it is None:
                continue  # no shape inference: the user set n_in
            if isinstance(layer, _CNN2D_LAYERS):
                if it.kind == "convolutionalFlat":
                    preprocessors[i] = (f"to_conv:{it.height},{it.width},"
                                        f"{it.channels}")
                    it = InputType.convolutional(it.height, it.width,
                                                 it.channels)
                elif it.kind != "convolutional":
                    raise ValueError(
                        f"Layer {i} ({type(layer).__name__}) needs image "
                        f"input, got {it.kind}")
            elif isinstance(layer, _CNN3D_LAYERS):
                if it.kind != "convolutional3d":
                    raise ValueError(
                        f"Layer {i} ({type(layer).__name__}) needs 3D image "
                        f"input, got {it.kind}")
            elif isinstance(layer, _RNN_LAYERS):
                if it.kind != "recurrent":
                    raise ValueError(
                        f"Layer {i} ({type(layer).__name__}) needs recurrent "
                        f"input, got {it.kind}")
            elif isinstance(layer, DenseLayer):
                if it.kind in ("convolutional", "convolutional3d"):
                    preprocessors[i] = "flatten"
                    it = InputType.feedForward(it.flat_size())
                elif it.kind == "convolutionalFlat":
                    it = InputType.feedForward(it.flat_size())
            target = _n_in_holder(layer)
            if getattr(target, "n_in", 0) in (0, None) \
                    and hasattr(target, "n_in") \
                    and not isinstance(target, EmbeddingLayer):
                target.n_in = (it.channels if it.kind in (
                    "convolutional", "convolutional3d") else it.size)
            if isinstance(layer, _ATTENTION_LAYERS) and layer.n_out == 0:
                layer.n_out = layer.n_in
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
            preprocessors=preprocessors, gradient_normalization=p._grad_norm,
            gradient_normalization_threshold=p._grad_norm_threshold,
            tbptt_fwd_length=tbptt_fwd, tbptt_back_length=tbptt_back)


def _n_in_holder(layer: Layer) -> Layer:
    """The layer that holds ``n_in`` inside wrappers: a
    ``LastTimeStep``'s underlying layer, or the wrapped ``layer`` of a
    class whose ``n_in`` is a property (``Bidirectional``,
    ``MaskZeroLayer``)."""
    while True:
        if isinstance(layer, LastTimeStep):
            layer = layer.underlying
        elif isinstance(type(layer).__dict__.get("n_in"), property) \
                or not hasattr(layer, "n_in"):
            inner = getattr(layer, "layer", None)
            if not (isinstance(inner, Layer) and hasattr(inner, "n_in")):
                return layer
            layer = inner
        else:
            return layer


def _image_shape(tag: str) -> Tuple[int, int, int]:
    """(H, W, C) of a ``"to_conv:H,W,C"`` tag."""
    h, w, c = (int(v) for v in tag.split(":", 1)[1].split(","))
    return h, w, c


def apply_preprocessor(tag: str, x):
    """A preprocessor tag's reshape of ``x``."""
    if tag == "flatten":
        return x.reshape(x.shape[0], -1)
    if tag.startswith("to_conv:"):
        return x.reshape(x.shape[0], *_image_shape(tag))
    if tag == "to_rnn":
        return x
    raise ValueError(f"Unknown preprocessor: {tag}")


def preprocessor_output_type(tag: str, it: InputType) -> InputType:
    """The input type that a preprocessor tag's reshape of ``it`` gives."""
    if tag == "flatten":
        return InputType.feedForward(it.flat_size())
    if tag.startswith("to_conv:"):
        return InputType.convolutional(*_image_shape(tag))
    return it


__all__ = ["MultiLayerConfiguration", "NeuralNetConfiguration", "Builder",
           "ListBuilder", "apply_preprocessor", "preprocessor_output_type"]
