"""Transfer learning: counterpart of ``deeplearning4j_tpu/nn/transferlearning.py``
(freezing, network surgery and the featurize-once workflow).

:class:`FrozenLayer` wraps a layer whose parameters take no gradient and
no update (the ``NoOp`` updater), run in inference mode;
:class:`FrozenLayerWithBackprop` keeps the wrapped layer's training mode
and passes the input gradient on (a WGAN's frozen critic).
``TransferLearning.Builder`` edits a ``MultiLayerNetwork`` (freeze a
prefix, remove layers from the output, add layers, ``nOutReplace``) and
:class:`TransferLearningGraphBuilder` (``TransferLearning.GraphBuilder``)
a ``ComputationGraph``, on ``nn.graph.vertices.FrozenVertex``.
``FineTuneConfiguration.dropout`` is recorded and not applied, as in the
JAX builders.

A frozen feature extractor costs forward-only here too: the networks
leave frozen parameters out of ``torch.autograd.grad`` and out of the
updater, and a frozen layer whose input needs no gradient runs without
recording an autograd graph. The built network shares the source's
tensors for the layers it keeps (a step replaces a tensor, it never
writes into one), so fine-tuning leaves the source as it was;
``TransferLearningHelper.fitFeaturized`` writes the tail's parameters
back into the network it was given, on purpose.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, NoOp
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.params import tree_map


def _frozen(params):
    return tree_map(lambda t: t.detach(), params)


def _record(x) -> bool:
    """Whether a frozen layer's forward must be recorded for autograd:
    only where its input carries a gradient."""
    return torch.is_grad_enabled() and torch.is_tensor(x) and x.requires_grad


@serializable
@dataclasses.dataclass
class FrozenLayer(Layer):
    """``layer`` with its parameters frozen (detached, the ``NoOp``
    updater) and run in inference mode (no dropout, running batch-norm
    statistics)."""

    layer: Optional[Layer] = None

    #: the networks leave a frozen layer's parameters out of the gradient
    frozen_params = True

    def __post_init__(self):
        super().__post_init__()
        self.updater = NoOp()

    @property
    def is_recurrent(self):
        return self.layer is not None and self.layer.is_recurrent

    def _train(self, train: bool) -> bool:
        return False

    def has_params(self):
        return self.layer.has_params()

    def output_type(self, it):
        return self.layer.output_type(it)

    def init_params(self, generator, it, dtype, device):
        return self.layer.init_params(generator, it, dtype, device)

    def init_state(self, it, dtype, device):
        return self.layer.init_state(it, dtype, device)

    def apply(self, params, state, x, train, generator):
        with torch.set_grad_enabled(_record(x)):
            return self.layer.apply(_frozen(params), state, x,
                                    self._train(train), generator)

    def init_carry(self, batch, dtype, device):
        return self.layer.init_carry(batch, dtype, device)

    def apply_with_carry(self, params, state, carry, x, train, generator):
        with torch.set_grad_enabled(_record(x)):
            return self.layer.apply_with_carry(
                _frozen(params), state, carry, x, self._train(train),
                generator)


@serializable
@dataclasses.dataclass
class FrozenLayerWithBackprop(FrozenLayer):
    """Frozen parameters, but the wrapped layer keeps its training-mode
    behaviour (dropout, batch statistics) and the input gradient flows to
    the layers below."""

    def _train(self, train: bool) -> bool:
        return train


@dataclasses.dataclass
class FineTuneConfiguration:
    """Overrides for the edited network: updater, seed, l1, l2 (and
    ``dropout``, recorded but not applied, as in the JAX builders)."""

    updater: Optional[IUpdater] = None
    seed: Optional[int] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None


def _fine_tuned(conf, ftc: Optional[FineTuneConfiguration], **changes):
    """``conf`` with ``changes`` and the fine-tune overrides that are
    set."""
    ftc = ftc or FineTuneConfiguration()
    for field in ("seed", "updater", "l1", "l2"):
        v = getattr(ftc, field)
        changes[field] = v if v is not None else getattr(conf, field)
    return dataclasses.replace(conf, **changes)


class TransferLearning:
    """``TransferLearning.Builder(network)`` and
    ``TransferLearning.GraphBuilder(graph)``."""

    class Builder:
        def __init__(self, net):
            if net.params_list is None:
                raise ValueError("network must be init()ed / trained")
            self._net = net
            self._ftc: Optional[FineTuneConfiguration] = None
            self._freeze_up_to = -1          # inclusive layer index
            self._removed_from_output = 0
            self._added: List[Layer] = []
            self._nout_replace = {}          # idx -> (n_out, weight_init)

        def fineTuneConfiguration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def setFeatureExtractor(self, layer_idx: int):
            """Freeze layers ``[0, layer_idx]``."""
            self._freeze_up_to = int(layer_idx)
            return self

        def removeOutputLayer(self):
            return self.removeLayersFromOutput(1)

        def removeLayersFromOutput(self, n: int):
            self._removed_from_output += int(n)
            return self

        def addLayer(self, layer: Layer):
            self._added.append(layer)
            return self

        def nOutReplace(self, layer_idx: int, n_out: int,
                        weight_init: str = "xavier"):
            """Layer ``layer_idx`` re-initialised with ``n_out`` outputs,
            and the next layer re-initialised with that ``n_in``."""
            self._nout_replace[int(layer_idx)] = (int(n_out), weight_init)
            return self

        def build(self):
            """The edited network on the source's device: the kept
            layers share the source's tensors, re-initialised and added
            layers take fresh ones from the new configuration's seed."""
            from deeplearning4j_tpu_torch.nn.multilayer.network import (
                MultiLayerNetwork)

            src = self._net
            conf = src.conf
            n_keep = len(conf.layers) - self._removed_from_output
            if n_keep <= 0:
                raise ValueError("removed every layer")
            new_layers: List[Layer] = []
            reinit = set()
            for i in range(n_keep):
                layer = copy.deepcopy(conf.layers[i])
                if i in self._nout_replace:
                    layer.n_out, layer.weight_init = self._nout_replace[i]
                    reinit.add(i)
                    # the next layer consumes the new width
                    if i + 1 < n_keep and hasattr(conf.layers[i + 1], "n_in"):
                        reinit.add(i + 1)
                new_layers.append(layer)
            for i, (n_out, _) in self._nout_replace.items():
                if i + 1 < n_keep and hasattr(new_layers[i + 1], "n_in"):
                    new_layers[i + 1].n_in = n_out
            new_layers.extend(copy.deepcopy(extra) for extra in self._added)
            for i in range(min(self._freeze_up_to + 1, len(new_layers))):
                if new_layers[i].has_params():
                    new_layers[i] = FrozenLayer(layer=new_layers[i])
            new_conf = _fine_tuned(conf, self._ftc, layers=new_layers,
                                   preprocessors=dict(conf.preprocessors))
            out = MultiLayerNetwork(new_conf, device=src.device).init()
            for i in range(n_keep):
                if i not in reinit:
                    out.params_list[i] = dict(src.params_list[i])
                    out.states_list[i] = dict(src.states_list[i])
            return out


class TransferLearningHelper:
    """The featurize-once workflow: the frozen layers run once over a
    dataset (:meth:`featurize`), and only the head trains on the
    features (:meth:`fitFeaturized`), its parameters written back into
    the network."""

    def __init__(self, net, frozen_up_to: Optional[int] = None):
        from deeplearning4j_tpu_torch.nn.multilayer.network import (
            MultiLayerNetwork)

        self.net = net
        if frozen_up_to is None:
            frozen_up_to = -1
            for i, l in enumerate(net.conf.layers):
                if isinstance(l, FrozenLayer):
                    frozen_up_to = i
        self.frozen_up_to = frozen_up_to
        if frozen_up_to < 0:
            raise ValueError("no frozen layers — use setFeatureExtractor "
                             "or pass frozen_up_to")
        k = frozen_up_to + 1
        tail_layers = [copy.deepcopy(l) for l in net.conf.layers[k:]]
        tail_pre = {i - k: t for i, t in net.conf.preprocessors.items()
                    if i > frozen_up_to}
        tail_conf = dataclasses.replace(net.conf, layers=tail_layers,
                                        input_type=None,
                                        preprocessors=tail_pre)
        self._tail = MultiLayerNetwork(tail_conf, device=net.device).init()
        for j in range(len(tail_layers)):
            self._tail.params_list[j] = dict(net.params_list[k + j])
            self._tail.states_list[j] = dict(net.states_list[k + j])

    def featurize(self, ds):
        """``ds`` with its features run through the frozen layers
        (inference mode, no autograd)."""
        from deeplearning4j_tpu_torch.datasets import DataSet

        net = self.net
        a = net._tensor(ds.features, net._input_dtype)
        with torch.no_grad():
            for i in range(self.frozen_up_to + 1):
                a = net._cast_a(net._preprocess(i, a), i)
                a, _ = net.conf.layers[i].apply(
                    net._cast_p(net.params_list[i], i), net.states_list[i],
                    a, False, None)
        return DataSet(a, ds.labels, labels_mask=ds.labels_mask)

    def fitFeaturized(self, ds, epochs: int = 1) -> None:
        """Train the head on featurized data, then write its parameters
        and state back into the network."""
        self._tail.fit(ds.features, ds.labels, epochs=epochs)
        k = self.frozen_up_to + 1
        for j in range(len(self._tail.conf.layers)):
            self.net.params_list[k + j] = self._tail.params_list[j]
            self.net.states_list[k + j] = self._tail.states_list[j]

    def unfrozenMLN(self):
        return self._tail


class TransferLearningGraphBuilder:
    """Transfer learning on a ``ComputationGraph``: fineTuneConfiguration,
    setFeatureExtractor(vertex), removeVertexAndConnections,
    removeVertexKeepConnections, addLayer / addVertex, nOutReplace,
    setOutputs."""

    def __init__(self, graph):
        if graph.params_map is None:
            raise ValueError("graph must be init()ed / trained")
        self._g = graph
        self._ftc: Optional[FineTuneConfiguration] = None
        self._feature_extractor: Optional[str] = None
        self._removed: set = set()
        self._added: list = []           # (name, vertex, inputs)
        self._nout_replace = {}          # name -> (n_out, weight_init)
        self._new_outputs: Optional[list] = None

    def fineTuneConfiguration(self, ftc: FineTuneConfiguration):
        self._ftc = ftc
        return self

    def setFeatureExtractor(self, vertex_name: str):
        """Freeze ``vertex_name`` and everything upstream of it."""
        self._feature_extractor = vertex_name
        return self

    def removeVertexAndConnections(self, name: str):
        self._removed.add(name)
        return self

    def removeVertexKeepConnections(self, name: str):
        # the connections are declared again by addLayer / addVertex
        self._removed.add(name)
        return self

    def addLayer(self, name: str, layer, *inputs):
        from deeplearning4j_tpu_torch.nn.graph.vertices import LayerVertex

        self._added.append((name, LayerVertex(layer=layer), list(inputs)))
        return self

    def addVertex(self, name: str, vertex, *inputs):
        self._added.append((name, vertex, list(inputs)))
        return self

    def nOutReplace(self, name: str, n_out: int,
                    weight_init: str = "xavier"):
        self._nout_replace[name] = (int(n_out), weight_init)
        return self

    def setOutputs(self, *names: str):
        self._new_outputs = list(names)
        return self

    @staticmethod
    def _ancestors(conf, name: str) -> set:
        """``name`` and every node upstream of it."""
        parents = {n.name: list(n.inputs) for n in conf.nodes}
        seen, stack = set(), [name]
        while stack:
            cur = stack.pop()
            if cur not in seen:
                seen.add(cur)
                stack.extend(parents.get(cur, []))
        return seen

    def build(self):
        """The edited graph on the source's device; kept vertices share
        the source's tensors."""
        from deeplearning4j_tpu_torch.nn.graph.config import GraphNode
        from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.graph.vertices import (FrozenVertex,
                                                                LayerVertex)

        src = self._g
        conf = src.conf
        re_added = {n for n, _, _ in self._added}
        removed = set(self._removed) - re_added
        # a removed vertex takes everything downstream with it, unless
        # added again (names added again do not pass the removal on)
        for node in conf.nodes:
            if node.name not in re_added \
                    and any(s in removed for s in node.inputs):
                removed.add(node.name)
        frozen = (self._ancestors(conf, self._feature_extractor)
                  if self._feature_extractor is not None else set())
        # nOutReplace: the consumers take the new n_in and a re-init
        consumers = {}
        for node in conf.nodes:
            for s in node.inputs:
                consumers.setdefault(s, []).append(node.name)
        reinit, adjust_nin = set(), {}
        for tgt, (n_out, _) in self._nout_replace.items():
            reinit.add(tgt)
            for c in consumers.get(tgt, []):
                adjust_nin[c] = n_out
                reinit.add(c)
        added_by_name = {n: (v, i) for n, v, i in self._added}
        new_nodes, placed = [], set()
        for node in conf.nodes:
            if node.name in re_added:
                # replaced in place: it keeps its topological position
                v, i = added_by_name[node.name]
                new_nodes.append(GraphNode(name=node.name, vertex=v,
                                           inputs=i))
                placed.add(node.name)
                continue
            if node.name in removed:
                continue
            vertex = copy.deepcopy(node.vertex)
            if node.name in self._nout_replace:
                if not isinstance(vertex, LayerVertex):
                    raise ValueError(
                        f"nOutReplace target {node.name!r} is not a layer")
                vertex.layer.n_out, vertex.layer.weight_init = \
                    self._nout_replace[node.name]
            if node.name in adjust_nin and isinstance(vertex, LayerVertex) \
                    and hasattr(vertex.layer, "n_in"):
                vertex.layer.n_in = adjust_nin[node.name]
            if node.name in frozen and src.params_map.get(node.name):
                vertex = FrozenVertex(vertex=vertex)
            new_nodes.append(GraphNode(name=node.name, vertex=vertex,
                                       inputs=list(node.inputs)))
        for name, vertex, inputs in self._added:
            if name not in placed:
                new_nodes.append(GraphNode(name=name, vertex=vertex,
                                           inputs=inputs))
        new_conf = _fine_tuned(
            conf, self._ftc, nodes=new_nodes,
            network_outputs=self._new_outputs or [
                o for o in conf.network_outputs if o not in removed])
        out = ComputationGraph(new_conf, device=src.device).init()
        for node in new_conf.nodes:
            name = node.name
            if name in reinit or name in re_added \
                    or name not in src.params_map:
                continue
            out.params_map[name] = dict(src.params_map[name])
            out.states_map[name] = dict(src.states_map[name])
        return out


TransferLearning.GraphBuilder = TransferLearningGraphBuilder

__all__ = ["TransferLearning", "TransferLearningGraphBuilder",
           "FineTuneConfiguration", "FrozenLayer", "FrozenLayerWithBackprop",
           "TransferLearningHelper"]
