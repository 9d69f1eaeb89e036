"""ComputationGraphConfiguration and GraphBuilder: counterpart of
``deeplearning4j_tpu/nn/graph/config.py``.

The same fluent API (``graphBuilder().addInputs(...).addLayer(name, conf,
*inputs).addVertex(name, vertex, *inputs).setOutputs(...)
.setInputTypes(...).build()``) and the same ``build``: Kahn's
topological order taken exactly as the reference takes it, so the
parameter, state and updater trees match the JAX graph's key for key;
global defaults cloned into the layers; type and ``n_in`` inference; a
``"flatten"`` preprocessor vertex before a dense layer on image input;
and the JSON round-trip that reads what the JAX side writes, the
precision policy included (``precision(...)``: a preset name or an
``nn.precision.PrecisionPolicy``, whose ``layer_overrides`` are keyed by
vertex name).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.common import serde
from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.learning.updaters import Sgd
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, Layer
from deeplearning4j_tpu_torch.nn.graph.vertices import (
    GraphVertex, LayerVertex, PreprocessorVertex)
# registers PrecisionPolicy with the JSON serde
from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy  # noqa: F401


@serializable
@dataclasses.dataclass
class GraphNode:
    name: str = ""
    vertex: Any = None
    inputs: List = dataclasses.field(default_factory=list)


@serializable
@dataclasses.dataclass
class ComputationGraphConfiguration:
    nodes: List = dataclasses.field(default_factory=list)  # topo-sorted
    network_inputs: List = dataclasses.field(default_factory=list)
    network_outputs: List = dataclasses.field(default_factory=list)
    input_types: List = dataclasses.field(default_factory=list)
    seed: int = 12345
    updater: Any = dataclasses.field(default_factory=lambda: Sgd())
    weight_init: str = "xavier"
    l1: float = 0.0
    l2: float = 0.0
    dtype: str = "float32"
    #: the precision policy, as ``MultiLayerConfiguration.precision``
    precision: Optional[Any] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0

    def to_json(self) -> str:
        return serde.to_json(self)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        cfg = serde.from_json(s)
        if not isinstance(cfg, ComputationGraphConfiguration):
            raise ValueError(f"not a ComputationGraphConfiguration: "
                             f"{type(cfg).__name__}")
        return cfg

    @staticmethod
    def graphBuilder() -> "GraphBuilder":
        return GraphBuilder()


class GraphBuilder:
    def __init__(self):
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._nodes: Dict[str, GraphNode] = {}
        self._order: List[str] = []
        self._input_types: List[InputType] = []
        self._seed = 12345
        self._updater = Sgd()
        self._weight_init = "xavier"
        self._l1 = 0.0
        self._l2 = 0.0
        self._dtype = "float32"
        self._precision = None
        self._grad_norm = None
        self._grad_norm_t = 1.0

    # -- fluent config --------------------------------------------------
    def seed(self, s):
        self._seed = int(s)
        return self

    def updater(self, u):
        self._updater = u
        return self

    def weightInit(self, w):
        self._weight_init = w.value if hasattr(w, "value") else str(w)
        return self

    def l2(self, v):
        self._l2 = float(v)
        return self

    def l1(self, v):
        self._l1 = float(v)
        return self

    def dataType(self, dt):
        self._dtype = dt.value if hasattr(dt, "value") else str(dt)
        return self

    def precision(self, policy):
        """The precision policy (a preset name or a ``PrecisionPolicy``),
        as ``NeuralNetConfiguration.Builder.precision``."""
        self._precision = policy
        return self

    def gradientNormalization(self, mode, threshold=1.0):
        self._grad_norm = mode
        self._grad_norm_t = threshold
        return self

    # -- graph assembly -------------------------------------------------
    def addInputs(self, *names) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def addLayer(self, name: str, layer: Layer, *inputs) -> "GraphBuilder":
        return self.addVertex(name, LayerVertex(layer=layer), *inputs)

    def layer(self, name, layer, *inputs) -> "GraphBuilder":
        return self.addLayer(name, layer, *inputs)

    def addVertex(self, name: str, vertex: GraphVertex,
                  *inputs) -> "GraphBuilder":
        if name in self._nodes or name in self._inputs:
            raise ValueError(f"Duplicate node name: {name}")
        self._nodes[name] = GraphNode(name=name, vertex=vertex,
                                      inputs=list(inputs))
        self._order.append(name)
        return self

    def setOutputs(self, *names) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def setInputTypes(self, *its) -> "GraphBuilder":
        self._input_types = list(its)
        return self

    def _topo_order(self) -> List[str]:
        """Kahn's order, in the reference's tie-breaking: ready nodes in
        insertion order, first in first out."""
        indeg = {n: 0 for n in self._order}
        for n in self._order:
            for src in self._nodes[n].inputs:
                if src not in self._inputs and src not in self._nodes:
                    raise ValueError(
                        f"Node {n} references unknown input {src}")
                if src in self._nodes:
                    indeg[n] += 1
        ready = [n for n in self._order if indeg[n] == 0]
        deps = {n: [m for m in self._order if n in self._nodes[m].inputs]
                for n in self._order}
        topo: List[str] = []
        while ready:
            n = ready.pop(0)
            topo.append(n)
            for m in deps[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(topo) != len(self._order):
            raise ValueError("Graph has a cycle")
        return topo

    def build(self) -> ComputationGraphConfiguration:
        if not self._inputs or not self._outputs:
            raise ValueError("Graph needs addInputs(...) and setOutputs(...)")
        types: Dict[str, InputType] = dict(zip(self._inputs,
                                               self._input_types))
        final_nodes: List[GraphNode] = []
        for name in self._topo_order():
            node = self._nodes[name]
            v = node.vertex
            if isinstance(v, LayerVertex):
                layer = v.layer
                if layer.weight_init is None:
                    layer.weight_init = self._weight_init
                if layer.l1 is None:
                    layer.l1 = self._l1
                if layer.l2 is None:
                    layer.l2 = self._l2
            if types:
                in_types = [types[s] for s in node.inputs]
                if isinstance(v, LayerVertex) \
                        and isinstance(v.layer, DenseLayer) \
                        and in_types[0].kind == "convolutional":
                    pre_name = f"{name}-flatten"
                    final_nodes.append(GraphNode(
                        name=pre_name,
                        vertex=PreprocessorVertex(tag="flatten"),
                        inputs=list(node.inputs)))
                    types[pre_name] = InputType.feedForward(
                        in_types[0].flat_size())
                    node.inputs = [pre_name]
                    in_types = [types[pre_name]]
                if isinstance(v, LayerVertex):
                    layer, it0 = v.layer, in_types[0]
                    if getattr(layer, "n_in", 1) in (0, None):
                        layer.n_in = (it0.channels
                                      if it0.kind == "convolutional"
                                      else it0.size)
                types[name] = v.output_type(in_types)
            final_nodes.append(node)

        return ComputationGraphConfiguration(
            nodes=final_nodes, network_inputs=self._inputs,
            network_outputs=self._outputs, input_types=self._input_types,
            seed=self._seed, updater=self._updater,
            weight_init=self._weight_init, l1=self._l1, l2=self._l2,
            dtype=self._dtype, precision=self._precision,
            gradient_normalization=self._grad_norm,
            gradient_normalization_threshold=self._grad_norm_t)


__all__ = ["GraphNode", "ComputationGraphConfiguration", "GraphBuilder"]
