"""ComputationGraph: counterpart of ``deeplearning4j_tpu/nn/graph/graph.py``.

A directed acyclic network of vertices walked in the configuration's
topological order. The JAX graph compiles each training step into one XLA
program; here a step is eager PyTorch: the forward through the vertices
to every output's loss (summed), one ``torch.autograd.grad`` into every
parameter, gradient normalisation, then one
:func:`~deeplearning4j_tpu_torch.learning.updaters.apply_updater` per
vertex (``params - updates`` in each parameter's dtype). Convolutions run
cuDNN through ``F.conv2d`` on the card (``ops.nn``); the image layers
reach no Pallas kernel in the reference, so no hand kernel here. A
training step names each vertex's ops and the update as profiler record
ranges (``dl4j::<layer class>``, ``dl4j::updater``), so a trace sums the
device time by layer kind.

Ported: ``init``, ``fit`` (arrays, lists of arrays, a ``DataSet``, a
``MultiDataSet``, or a ``DataSetIterator`` or ``MultiDataSetIterator``,
with label masks), ``output`` / ``outputSingle``, ``score``, ``evaluate``
and its ROC and regression variants, the listeners, ``clone``,
``numParams``, ``params``, ``setParams``, l1/l2 on the weights and
gradient normalisation. Not ported yet, and raising
``NotImplementedError`` with the ROADMAP item: features masks,
pretraining, ``rnnTimeStep`` and ``backpropGradient`` (A3); the health
monitor and fault tolerance (A9); loss scaling and the mixed policies
(A2, refused by the configuration). ``fit`` over an iterator takes a
batch already on the device in the input dtype without a copy, and
records each ``next()``'s wait in ``_last_etl_ms``.

Parameters, layer state and updater state are dicts keyed by node name
in the JAX layout, so ``params.cg_params_from_numpy`` and
``util.model_serializer`` carry a JAX graph across unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from deeplearning4j_tpu_torch.datasets import (DataSet, DataSetIterator,
                                               MultiDataSet,
                                               MultiDataSetIterator)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.learning.updaters import apply_updater
from deeplearning4j_tpu_torch.nn.graph.config import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.graph.vertices import LayerVertex
from deeplearning4j_tpu_torch.nn.multilayer.network import (
    _not_ported, as_device_tensor, eval_mask, fit_epochs,
    normalize_gradients, torch_dtype, weight_penalty)


def _label(vertex) -> str:
    """The profiler's name for a vertex's ops in a training step:
    ``dl4j::`` and its layer's class (or the vertex's own)."""
    if isinstance(vertex, LayerVertex):
        return f"dl4j::{type(vertex.layer).__name__}"
    return f"dl4j::{type(vertex).__name__}"


class ComputationGraph:
    """A graph network on one device: the CUDA card unless the caller
    passes ``device="cpu"`` (without a card and without a device it
    raises)."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self._dtype = torch_dtype(conf.dtype)
        self.params_map: Optional[Dict[str, dict]] = None
        self.states_map: Optional[Dict[str, dict]] = None
        self.opt_states: Optional[Dict[str, Any]] = None
        self._updaters: Dict[str, Any] = {}
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")
        self._generator: Optional[torch.Generator] = None
        self._listeners: List[Any] = []
        self._last_etl_ms: Optional[float] = None
        self._last_batch_size = 0

    # ------------------------------------------------------------------
    def init(self) -> "ComputationGraph":
        """Parameters from a ``torch.Generator`` seeded with
        ``conf.seed`` (not the JAX draws), node by node in topological
        order, zero updater state, and the dropout generator."""
        conf = self.conf
        if not conf.input_types:
            raise ValueError("setInputTypes(...) required before init()")
        gen = torch.Generator().manual_seed(int(conf.seed))
        types = dict(zip(conf.network_inputs, conf.input_types))
        self.params_map, self.states_map, self.opt_states = {}, {}, {}
        for node in conf.nodes:
            in_types = [types[s] for s in node.inputs]
            v = node.vertex
            p = v.init_params(gen, in_types, self._dtype, self.device)
            self.params_map[node.name] = p
            self.states_map[node.name] = v.init_state(in_types, self._dtype,
                                                      self.device)
            upd = conf.updater
            if isinstance(v, LayerVertex) and v.layer.updater is not None:
                upd = v.layer.updater
            self._updaters[node.name] = upd
            self.opt_states[node.name] = upd.init_state(p)
            types[node.name] = v.output_type(in_types)
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(conf.seed) + 7919)
        return self

    def _check_init(self):
        if self.params_map is None:
            raise RuntimeError("Call init() first")

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return as_device_tensor(a, self.device, dtype)

    def _inputs(self, xs) -> Dict[str, torch.Tensor]:
        names = self.conf.network_inputs
        if len(xs) != len(names):
            raise ValueError(f"got {len(xs)} feature arrays for "
                             f"{len(names)} graph inputs {names}")
        return {n: self._tensor(x, self._dtype) for n, x in zip(names, xs)}

    @staticmethod
    def _no_feature_masks(feature_masks):
        if feature_masks is not None and any(m is not None
                                             for m in feature_masks):
            raise _not_ported("features masks on a ComputationGraph", "A3")

    # ------------------------------------------------------------------
    def _forward_all(self, params_map, states_map, inputs: dict, train,
                     generator):
        """Every vertex's output, in topological order: ``(acts,
        new_states)``."""
        acts: Dict[str, Any] = dict(inputs)
        new_states: Dict[str, dict] = {}
        for node in self.conf.nodes:
            acts[node.name], new_states[node.name] = node.vertex.apply(
                params_map[node.name], states_map[node.name],
                [acts[s] for s in node.inputs], train, generator)
        return acts, new_states

    def _loss(self, params_map, states_map, inputs, labels_map, generator,
              masks_map=None):
        """Training-mode forward to every output's loss head: ``(loss,
        (new_states, data_loss))``, the losses summed in f32 and
        ``loss`` with the l1/l2 terms of the weights."""
        masks_map = masks_map or {}
        outputs = self.conf.network_outputs
        acts: Dict[str, Any] = dict(inputs)
        new_states: Dict[str, dict] = {}
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for node in self.conf.nodes:
            xs = [acts[s] for s in node.inputs]
            v, name = node.vertex, node.name
            with record_function(_label(v)):
                if name in outputs and isinstance(v, LayerVertex) \
                        and hasattr(v.layer, "loss_value"):
                    total = total + v.layer.loss_value(
                        params_map[name], states_map[name], xs[0],
                        labels_map[name], masks_map.get(name))
                    new_states[name] = states_map[name]
                    acts[name] = xs[0]
                else:
                    acts[name], new_states[name] = v.apply(
                        params_map[name], states_map[name], xs, True,
                        generator)
        reg = weight_penalty(
            ((n.vertex.layer, params_map[n.name]) for n in self.conf.nodes
             if isinstance(n.vertex, LayerVertex)),
            torch.zeros((), dtype=torch.float32, device=self.device))
        return total + reg, (new_states, total)

    def _clip(self, grads: Dict[str, dict]) -> Dict[str, dict]:
        conf = self.conf
        return {n: normalize_gradients(conf.gradient_normalization,
                                       conf.gradient_normalization_threshold,
                                       g) for n, g in grads.items()}

    def _train_step(self, inputs, labels, masks):
        """One update: forward, gradients of every parameter, clipping,
        updater. Returns the data loss, detached."""
        leaves = {n: {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
                  for n, p in self.params_map.items()}
        with torch.enable_grad():
            loss, (new_states, data_loss) = self._loss(
                leaves, self.states_map, inputs, labels, self._generator,
                masks)
            flat = [v for p in leaves.values() for v in p.values()]
            got = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        grads = {n: {k: (lambda g, v: torch.zeros_like(v) if g is None
                         else g)(next(got), v) for k, v in p.items()}
                 for n, p in leaves.items()}
        del leaves, flat, loss
        with torch.no_grad(), record_function("dl4j::updater"):
            self._apply_updates(self._clip(grads))
        self.states_map = new_states
        return data_loss.detach()

    def _apply_updates(self, grads: Dict[str, dict]) -> None:
        """One ``apply_updater`` per vertex; ``p - u`` in the parameter's
        dtype."""
        for name, p in self.params_map.items():
            updates, self.opt_states[name] = apply_updater(
                self._updaters[name], self.opt_states[name], grads[name], p,
                self._iteration)
            self.params_map[name] = {k: p[k] - updates[k] for k in p}

    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1, fault_tolerance=None,
            auto_resume=None):
        """Train on arrays ``fit(x, y)`` (one per graph input and output,
        or lists of them), a ``DataSet`` or a ``MultiDataSet`` (``epochs``
        passes over the one batch), or a ``DataSetIterator`` or
        ``MultiDataSetIterator`` (``epochs`` passes, each ending in the
        listeners' ``onEpochEnd``; more than one needs an iterator that
        can reset)."""
        self._check_init()
        if fault_tolerance is not None or auto_resume is not None:
            raise _not_ported("fit(fault_tolerance=..., auto_resume=...)",
                              "A9")
        if isinstance(data, MultiDataSetIterator):
            if epochs > 1 and not data.resetSupported():
                raise ValueError("epochs > 1 requires a resettable "
                                 "MultiDataSetIterator")
            return fit_epochs(self, data, epochs, lambda m: self._fit_batch(
                m.features, m.labels, m.labels_mask_arrays or None,
                m.features_mask_arrays or None))
        if isinstance(data, DataSetIterator):
            return fit_epochs(self, data, epochs, lambda d: self._fit_batch(
                [d.features], [d.labels], [d.labels_mask],
                [d.features_mask]))
        self._last_etl_ms = None
        if isinstance(data, MultiDataSet):
            for _ in range(epochs):
                self._fit_batch(data.features, data.labels,
                                data.labels_mask_arrays or None,
                                data.features_mask_arrays or None)
            return self
        if isinstance(data, DataSet):
            for _ in range(epochs):
                self._fit_batch([data.features], [data.labels],
                                [data.labels_mask], [data.features_mask])
            return self
        if not (torch.is_tensor(data) or isinstance(data, (np.ndarray, list,
                                                           tuple))):
            raise TypeError(
                f"fit({type(data).__name__}): expected arrays, a DataSet, a "
                f"MultiDataSet or an iterator of them")
        if labels is None:
            raise ValueError("fit(inputs, labels) requires labels")
        data = list(data) if isinstance(data, (list, tuple)) else [data]
        labels = (list(labels) if isinstance(labels, (list, tuple))
                  else [labels])
        for _ in range(epochs):
            self._fit_batch(data, labels)
        return self

    def _fit_batch(self, xs: Sequence, ys: Sequence, label_masks=None,
                   feature_masks=None):
        outputs = self.conf.network_outputs
        self._no_feature_masks(feature_masks)
        inputs = self._inputs(xs)
        if len(ys) != len(outputs):
            raise ValueError(f"got {len(ys)} label arrays for "
                             f"{len(outputs)} graph outputs {outputs}")
        labels = {n: self._tensor(y) for n, y in zip(outputs, ys)}
        masks = {}
        if label_masks:
            if len(label_masks) != len(outputs):
                raise ValueError(
                    f"got {len(label_masks)} label masks for {len(outputs)} "
                    f"graph outputs {outputs} (use None placeholders for "
                    f"unmasked outputs)")
            masks = {n: self._tensor(m) for n, m in zip(outputs, label_masks)
                     if m is not None}
        self._score = self._train_step(inputs, labels, masks)
        self._iteration += 1
        self._last_batch_size = int(next(iter(inputs.values())).shape[0])
        for l in self._listeners:
            l.iterationDone(self, self._iteration, self._epoch)

    # ------------------------------------------------------------------
    def output(self, *xs, feature_masks=None):
        """The graph's outputs for ``xs`` (one array per input), in
        inference mode: a list of tensors on the device."""
        self._check_init()
        self._no_feature_masks(feature_masks)
        with torch.no_grad():
            acts, _ = self._forward_all(self.params_map, self.states_map,
                                        self._inputs(xs), False, None)
        return [acts[o] for o in self.conf.network_outputs]

    def outputSingle(self, *xs, feature_masks=None):
        return self.output(*xs, feature_masks=feature_masks)[0]

    def score(self, dataset: Optional[DataSet] = None) -> float:
        """The last minibatch's loss (without the l1/l2 terms), or the
        loss (with them, batch statistics in training mode, as the
        reference takes it) on ``dataset``."""
        if dataset is None:
            return float(self._score)
        self._check_init()
        conf = self.conf
        inputs = self._inputs([dataset.features])
        labels = {conf.network_outputs[0]: self._tensor(dataset.labels)}
        with torch.no_grad():
            loss, _ = self._loss(self.params_map, self.states_map, inputs,
                                 labels, None)
        return float(loss)

    # ------------------------------------------------------------------
    def _flat_order(self):
        return [(node.name, k) for node in self.conf.nodes
                for k in sorted(self.params_map[node.name])]

    def numParams(self) -> int:
        self._check_init()
        return sum(int(t.numel()) for p in self.params_map.values()
                   for t in p.values())

    def params(self) -> torch.Tensor:
        """One flat vector of every parameter (a copy), node by node in
        topological order, keys sorted."""
        self._check_init()
        parts = [self.params_map[n][k].reshape(-1)
                 for n, k in self._flat_order()]
        return torch.cat(parts) if parts else torch.zeros(0,
                                                           device=self.device)

    def setParams(self, flat) -> None:
        """The inverse of :meth:`params`: each parameter from its slice of
        ``flat``, in its own dtype."""
        self._check_init()
        v = self._tensor(flat)
        off = 0
        for name, k in self._flat_order():
            p = self.params_map[name][k]
            n = int(p.numel())
            self.params_map[name][k] = v[off:off + n].reshape(p.shape).to(
                p.dtype)
            off += n

    def _evaluate(self, ev, iterator):
        """``ev.eval`` over ``iterator``'s batches of the single output in
        inference mode (the counts stay on the device)."""
        for ds in iterator:
            fms = ([ds.features_mask] if ds.features_mask is not None
                   else None)
            out = self.outputSingle(ds.features, feature_masks=fms)
            ev.eval(ds.labels, out, mask=eval_mask(ds))
        return ev

    def evaluate(self, iterator):
        """Classification ``Evaluation`` over ``iterator``."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation

        return self._evaluate(Evaluation(), iterator)

    def evaluateROC(self, iterator, threshold_steps=0):
        """Binary ``ROC`` over the single output (exact sweep)."""
        from deeplearning4j_tpu_torch.evaluation import ROC

        return self._evaluate(ROC(), iterator)

    def evaluateROCMultiClass(self, iterator, threshold_steps=0):
        """One-vs-all ``ROCMultiClass`` (exact sweep)."""
        from deeplearning4j_tpu_torch.evaluation import ROCMultiClass

        return self._evaluate(ROCMultiClass(), iterator)

    def evaluateRegression(self, iterator):
        from deeplearning4j_tpu_torch.evaluation import RegressionEvaluation

        return self._evaluate(RegressionEvaluation(), iterator)

    def setListeners(self, *listeners):
        self._listeners = list(listeners)
        return self

    def addListeners(self, *listeners):
        self._listeners.extend(listeners)
        return self

    def getListeners(self):
        return list(self._listeners)

    def clone(self) -> "ComputationGraph":
        """A graph of the same configuration on the same device sharing
        this one's tensors (a step replaces tensors, it does not write
        into them); its counters and dropout generator start afresh, as
        the JAX clone's do."""
        m = ComputationGraph(self.conf, device=self.device)
        if self.params_map is not None:
            m.init()
            m.params_map = {n: dict(p) for n, p in self.params_map.items()}
            m.states_map = {n: dict(s) for n, s in self.states_map.items()}
            m.opt_states = dict(self.opt_states)
        return m

    def getIterationCount(self) -> int:
        return self._iteration

    def getEpochCount(self) -> int:
        return self._epoch

    # ------------------------------------------------------------------
    # not ported
    # ------------------------------------------------------------------
    def pretrain(self, *args, **kwargs):
        raise _not_ported("layerwise pretraining", "A3")

    pretrainLayer = pretrain

    def rnnTimeStep(self, *xs):
        raise _not_ported("ComputationGraph.rnnTimeStep", "A3")

    def backpropGradient(self, *args, **kwargs):
        raise _not_ported("backpropGradient", "A3")

    def setHealthMonitor(self, monitor):
        raise _not_ported("the model-health monitor", "A9")


__all__ = ["ComputationGraph"]
