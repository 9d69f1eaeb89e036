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
with label masks and a features mask on one input: the input's padded
steps zeroed and global pooling on its own branch masked), ``output`` /
``outputSingle`` (with features masks), ``rnnTimeStep`` and its state
accessors (every recurrent layer vertex keeps its carry between calls,
the encoder of a two-input graph included), ``backpropGradient``
(external errors), ``score``, ``evaluate`` and its ROC and regression
variants, the listeners, ``clone``, ``numParams``, ``params``,
``setParams``, l1/l2 on the weights, gradient normalisation, epoch-typed
learning-rate schedules, ``FrozenVertex`` (the ``NoOp`` updater; its
parameters left out of the gradient and the updater), the layers' weight
noise (in training) and constraints (after each update), layerwise
pretraining (``pretrainLayer``, ``pretrain``), ``summary`` and the
precision policies, with the seams of ``MultiLayerNetwork`` keyed by
vertex name: each vertex's inputs and parameters in its compute dtype
(``_cast_xs``, ``_cast_p``; a vertex that is not a layer takes the
policy's), the loss heads and normalization layers f32 islands, the
recurrent carries of ``rnnTimeStep`` in the layer's compute dtype, the
outputs of ``output``, ``rnnTimeStep`` and ``backpropGradient`` and the
external errors in the output dtype, and under ``mixed_float16`` the
loss-scaled step with its skip-step guard, the fault-tolerant fit
(``fit(fault_tolerance=..., auto_resume=...)``, ``util.resilience``) and
the model-health monitor (``setHealthMonitor``), with the step's phases,
memory watermarks and health hooks of ``MultiLayerNetwork``. ``fit`` over
an iterator takes a batch already on the device in the input dtype
without a copy, and records each ``next()``'s wait in ``_last_etl_ms``.

Parameters, layer state and updater state are dicts keyed by node name
in the JAX layout, so ``params.cg_params_from_numpy`` and
``util.model_serializer`` carry a JAX graph across unchanged.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from deeplearning4j_tpu_torch.datasets import (DataSet, DataSetIterator,
                                               MultiDataSet,
                                               MultiDataSetIterator)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.learning.schedules import uses_epoch_schedule
from deeplearning4j_tpu_torch.learning.updaters import NoOp, apply_updater
from deeplearning4j_tpu_torch.nn import precision as _precision
from deeplearning4j_tpu_torch.nn.conf.constraint import apply_constraints
from deeplearning4j_tpu_torch.nn.conf.layers import GlobalPoolingLayer
from deeplearning4j_tpu_torch.nn.graph.config import (
    ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.graph.vertices import (FrozenVertex,
                                                        LayerVertex)
from deeplearning4j_tpu_torch.nn.masking import validate_features_mask
from deeplearning4j_tpu_torch.nn.multilayer.network import (
    as_device_tensor, eval_mask, external_gradients, fit_epochs, grads_of,
    merged, normalize_gradients, pretrain_loss, trainable_leaves,
    weight_penalty, with_weight_noise)
from deeplearning4j_tpu_torch.params import tree_leaves, tree_map, tree_map2
from deeplearning4j_tpu_torch.profiler import flight_recorder as _flight
from deeplearning4j_tpu_torch.profiler import model_health as _model_health
from deeplearning4j_tpu_torch.profiler import telemetry as _telemetry


def _label(vertex) -> str:
    """The profiler's name for a vertex's ops in a training step:
    ``dl4j::`` and its layer's class (or the vertex's own; a frozen
    vertex's, the one it wraps)."""
    if isinstance(vertex, FrozenVertex):
        vertex = vertex.vertex
    if isinstance(vertex, LayerVertex):
        return f"dl4j::{type(vertex.layer).__name__}"
    return f"dl4j::{type(vertex).__name__}"


class ComputationGraph:
    """A graph network on one device: the CUDA card unless the caller
    passes ``device="cpu"`` (without a card and without a device it
    raises)."""

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self._nodes = {n.name: n for n in conf.nodes}
        self.device = resolve_device(device)
        self._policy = _precision.PrecisionPolicy.resolve(
            getattr(conf, "precision", None), conf.dtype)
        self._mixed = not self._policy.is_identity
        #: master, input (compute) and output dtypes, as in
        #: MultiLayerNetwork
        self._dtype = _precision.torch_dtype(self._policy.param_dtype)
        self._input_dtype = _precision.torch_dtype(self._policy.compute_dtype)
        self._out_dtype = _precision.torch_dtype(self._policy.output_dtype)
        self._compute_dtypes: Dict[str, torch.dtype] = {}
        self._loss_scale_state = None
        self._ls_seen = (0, 0)
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
        self._rnn_carries: Optional[Dict[str, Any]] = None
        self._rnn_batch = 0
        #: the model-health monitor (profiler/model_health.py), or None
        self._health = None

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
            if isinstance(v, FrozenVertex):
                # a parameter-aware updater (AdamW's decay) would move
                # frozen parameters at a zero gradient
                upd = NoOp()
            self._updaters[node.name] = upd
            self.opt_states[node.name] = upd.init_state(p)
            types[node.name] = v.output_type(in_types)
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(conf.seed) + 7919)
        self._compute_dtypes = {
            node.name: self._policy.layer_compute_dtype(
                getattr(node.vertex, "layer", None), node.name)
            for node in conf.nodes}
        self._loss_scale_state = _precision.init_loss_scale(
            self._policy, self.device)
        self._ls_seen = (0, 0)
        if self._mixed:
            _precision.record_cast_count("cg", sum(
                _precision.count_casts(p, self._compute_dtypes[n])
                for n, p in self.params_map.items()))
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
        return {n: self._tensor(x, self._input_dtype)
                for n, x in zip(names, xs)}

    # -- the mixed-precision seams (no-ops under a single-dtype policy) --
    def _cast_p(self, p, name: str):
        """Vertex ``name``'s master parameters in its compute dtype."""
        return _precision.cast_tree(p, self._compute_dtypes[name]) \
            if self._mixed else p

    def _cast_xs(self, xs, name: str):
        """The activations entering vertex ``name`` in its compute
        dtype."""
        if not self._mixed:
            return xs
        dt = self._compute_dtypes[name]
        return [_precision.cast_leaf(a, dt) for a in xs]

    def _cast_out(self, a):
        return _precision.cast_leaf(a, self._out_dtype) if self._mixed else a

    def _downstream_of(self, source: str) -> set:
        """The names of the nodes reachable from ``source`` (an input or a
        node), ``source`` included: masked pooling fires only on the
        masked input's own branch."""
        down = {source}
        for node in self.conf.nodes:       # topologically ordered
            if any(s in down for s in node.inputs):
                down.add(node.name)
        return down

    def _validate_fmasks(self, feature_masks, inputs: Dict[str, Any]):
        """``{input name: [N, T] mask}`` of the given features masks (one
        per graph input, None for an unmasked one), each validated
        against its ``[N, T, F]`` input; a mask on more than one input
        raises (masked pooling could not tell which applies)."""
        names = self.conf.network_inputs
        if not feature_masks:
            return {}
        if len(feature_masks) != len(names):
            raise ValueError(
                f"got {len(feature_masks)} feature masks for {len(names)} "
                f"graph inputs {names} (use None placeholders)")
        fmasks = {n: validate_features_mask(m, inputs[n], ctx=f"input {n!r}")
                  for n, m in zip(names, feature_masks) if m is not None}
        if len(fmasks) > 1:
            raise NotImplementedError(
                "features masks on more than one graph input are not "
                "supported (masked-pooling attribution would be "
                "ambiguous)")
        return fmasks

    def _masked_inputs(self, inputs, fmasks_map):
        """The activations after the inputs, each masked input's padded
        steps zeroed; the mask and the nodes downstream of its input."""
        acts: Dict[str, Any] = dict(inputs)
        fmask, branch = None, set()
        for name, fm in (fmasks_map or {}).items():
            acts[name] = acts[name] * fm[..., None].to(acts[name].dtype)
            fmask, branch = fm, self._downstream_of(name)
        return acts, fmask, branch

    @staticmethod
    def _pools_sequence(v, xs) -> bool:
        """Whether vertex ``v`` is global pooling over a sequence."""
        return (isinstance(v, LayerVertex)
                and isinstance(v.layer, GlobalPoolingLayer)
                and xs[0].dim() == 3)

    # ------------------------------------------------------------------
    def _forward_all(self, params_map, states_map, inputs: dict, train,
                     generator, fmasks_map=None):
        """Every vertex's output, in topological order: ``(acts,
        new_states)``. A features mask zeroes its input's padded steps
        and masks the global pooling on that input's branch, which
        raises if an upstream layer changed the sequence length."""
        acts, fmask, branch = self._masked_inputs(inputs, fmasks_map)
        new_states: Dict[str, dict] = {}
        for node in self.conf.nodes:
            xs = self._cast_xs([acts[s] for s in node.inputs], node.name)
            p = self._cast_p(params_map[node.name], node.name)
            v = node.vertex
            if fmask is not None and node.name in branch \
                    and self._pools_sequence(v, xs):
                if xs[0].shape[1] != fmask.shape[1]:
                    raise ValueError(
                        f"GlobalPoolingLayer {node.name!r}: features mask "
                        f"has {fmask.shape[1]} timesteps but the pooling "
                        f"input has {xs[0].shape[1]} — an upstream layer "
                        "changed the sequence length. Downsample/supply a "
                        "mask matching the pooled sequence length "
                        "(reference: MaskedReductionUtil).")
                out, ns = v.layer.apply_masked(
                    p, states_map[node.name], xs[0], fmask, train, generator)
            else:
                out, ns = v.apply(p, states_map[node.name], xs, train,
                                  generator)
            acts[node.name], new_states[node.name] = out, ns
        return acts, new_states

    def _loss(self, params_map, states_map, inputs, labels_map, generator,
              masks_map=None, fmasks_map=None, collect_acts=False):
        """Training-mode forward to every output's loss head: ``(loss,
        (new_states, data_loss))``, the losses summed in f32 and
        ``loss`` with the l1/l2 terms of the weights. A features mask acts
        as in :meth:`_forward_all`, the pooling masked only while the
        time axis still lines up. With ``collect_acts`` (a monitored step)
        the aux ends in the per-vertex non-finite flags, ``conf.nodes``
        order: each vertex's output, a loss head's loss value."""
        masks_map = masks_map or {}
        outputs = self.conf.network_outputs
        acts, fmask, branch = self._masked_inputs(inputs, fmasks_map)
        new_states: Dict[str, dict] = {}
        act_bad = [] if collect_acts else None
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for node in self.conf.nodes:
            v, name = node.vertex, node.name
            with record_function(_label(v)):
                # the loss heads are f32 islands under the mixed policies
                xs = self._cast_xs([acts[s] for s in node.inputs], name)
                p = with_weight_noise(getattr(v, "layer", None),
                                      self._cast_p(params_map[name], name),
                                      generator)
                if fmask is not None and name in branch \
                        and self._pools_sequence(v, xs) \
                        and xs[0].shape[1] == fmask.shape[1]:
                    acts[name], new_states[name] = v.layer.apply_masked(
                        p, states_map[name], xs[0], fmask, True, generator)
                    flagged = acts[name]
                elif name in outputs and isinstance(v, LayerVertex) \
                        and hasattr(v.layer, "loss_value"):
                    lv = v.layer.loss_value(
                        p, states_map[name], xs[0], labels_map[name],
                        masks_map.get(name))
                    total = total + lv
                    new_states[name] = states_map[name]
                    acts[name] = xs[0]
                    flagged = lv
                else:
                    acts[name], new_states[name] = v.apply(
                        p, states_map[name], xs, True, generator)
                    flagged = acts[name]
                if collect_acts:
                    act_bad.append(_model_health.act_flag(flagged))
        reg = weight_penalty(
            ((n.vertex.layer, params_map[n.name]) for n in self.conf.nodes
             if isinstance(n.vertex, LayerVertex)),
            torch.zeros((), dtype=torch.float32, device=self.device))
        if collect_acts:
            return total + reg, (new_states, total, act_bad)
        return total + reg, (new_states, total)

    def _clip(self, grads: Dict[str, dict]) -> Dict[str, dict]:
        conf = self.conf
        return {n: normalize_gradients(conf.gradient_normalization,
                                       conf.gradient_normalization_threshold,
                                       g) for n, g in grads.items()}

    def _train_step(self, inputs, labels, masks, fmasks=None):
        """One update: forward, gradients of every parameter that is not
        frozen, clipping, updater; under loss scaling the skip-step guard.
        Returns ``(data loss, detached; health)``, ``health`` the on-card
        health dict of a monitored step (None without a monitor)."""
        monitored = self._health is not None
        leaves = trainable_leaves(self.params_map, self._frozen)

        def loss_fn(pm):
            return self._loss(merged(pm, self.params_map, self._frozen),
                              self.states_map, inputs, labels,
                              self._generator, masks, fmasks,
                              collect_acts=monitored)

        ls = self._loss_scale_state
        if ls is not None:
            (_, aux), grads, finite = _precision.scaled_value_and_grad(
                loss_fn, ls, leaves)
        else:
            with torch.enable_grad():
                loss, aux = loss_fn(leaves)
                grads = grads_of(loss, leaves)
            del loss
        new_states, data_loss = aux[:2]
        del leaves
        with torch.no_grad(), record_function("dl4j::updater"):
            new_params, new_opt = self._apply_updates(self._clip(grads))
            if ls is not None:
                (new_params, new_opt, new_states,
                 self._loss_scale_state) = _precision.guard_scaled_step(
                    self._policy, ls, finite,
                    [(new_params, self.params_map),
                     (new_opt, self.opt_states),
                     (new_states, self.states_map)])
            health = None
            if monitored:
                health = _model_health.device_stats(
                    [n.name for n in self.conf.nodes], grads, new_params,
                    self.params_map, aux[2],
                    handled=None if ls is None else torch.logical_not(finite),
                    device=self.device)
        self.params_map, self.opt_states = new_params, new_opt
        self.states_map = new_states
        return data_loss.detach(), health

    def _node(self, name: str):
        return self._nodes[name]

    def _frozen(self, name: str) -> bool:
        return isinstance(self._node(name).vertex, FrozenVertex)

    def _update_one(self, name: str, p, opt_state, g, step: int):
        """Vertex ``name``'s parameters after one ``apply_updater`` at
        ``step`` (``p - u`` in the parameter's dtype) and its layer's
        constraints; a frozen vertex is left as it is (a ``FrozenVertex``
        has no layer of its own, so the wrapped layer's constraints do not
        apply, as in the JAX step). Returns ``(params, updater
        state)``."""
        if self._frozen(name):
            return p, opt_state
        updates, no = apply_updater(self._updaters[name], opt_state, g, p,
                                    step)
        p = tree_map2(lambda a, u: a - u, p, updates)
        layer = getattr(self._node(name).vertex, "layer", None)
        return (apply_constraints(layer, p) if layer is not None else p), no

    def _apply_updates(self, grads: Dict[str, dict]):
        """One update per vertex at the iteration count (the epoch count
        for an epoch-typed schedule). Returns the new parameters and
        updater state."""
        new_params, new_opt = {}, {}
        for name, p in self.params_map.items():
            step = (self._epoch if uses_epoch_schedule(self._updaters[name])
                    else self._iteration)
            new_params[name], new_opt[name] = self._update_one(
                name, p, self.opt_states[name], grads[name], step)
        return new_params, new_opt

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
            from deeplearning4j_tpu_torch.util import resilience

            return resilience.run_fit(self, fault_tolerance, data, labels,
                                      epochs, auto_resume=auto_resume)
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
        if all(torch.is_tensor(x) and x.device == self.device
               and x.dtype == self._input_dtype for x in xs):
            _telemetry.record_on_device_batch("cg")
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
        fmasks = self._validate_fmasks(feature_masks, inputs)
        hm = self._health
        t_step = time.perf_counter()
        if hm is None:
            self._score, health = self._train_step(inputs, labels, masks,
                                                   fmasks)
        else:
            sig = _model_health.step_signature(
                *inputs.values(), *labels.values(), *masks.values(),
                *fmasks.values())
            if hm.wants_flops("cg_step", sig):
                with _model_health.counting_flops() as box:
                    self._score, health = self._train_step(
                        inputs, labels, masks, fmasks)
                hm.record_flops("cg_step", sig, box["flops"])
            else:
                self._score, health = self._train_step(inputs, labels, masks,
                                                       fmasks)
            hm.charge_flops("cg_step", sig)
        _telemetry.record_phase("device_step", t_step)
        self._iteration += 1
        self._last_batch_size = int(next(iter(inputs.values())).shape[0])
        _flight.record_step("cg", self._iteration, t_step)
        _telemetry.sample_device_memory(self.device)
        if hm is not None:
            hm.on_step(self, health, site="cg", jit_site="cg_step")
        if self._loss_scale_state is not None:
            self._ls_seen = _precision.record_loss_scale(
                "cg", self._loss_scale_state, self._ls_seen)
        if self._listeners:
            t_l = time.perf_counter()
            for l in self._listeners:
                l.iterationDone(self, self._iteration, self._epoch)
            _telemetry.record_phase("listener_host", t_l)

    # ------------------------------------------------------------------
    def output(self, *xs, feature_masks=None):
        """The graph's outputs for ``xs`` (one array per input), in
        inference mode: a list of tensors on the device.
        ``feature_masks`` (one per input, None for an unmasked one) keeps
        inference consistent with masked training."""
        self._check_init()
        inputs = self._inputs(xs)
        fmasks = self._validate_fmasks(feature_masks, inputs)
        with torch.no_grad():
            acts, _ = self._forward_all(self.params_map, self.states_map,
                                        inputs, False, None, fmasks)
        return [self._cast_out(acts[o]) for o in self.conf.network_outputs]

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
        into them), the loss-scale state included; its counters and
        dropout generator start afresh, as the JAX clone's do."""
        m = ComputationGraph(self.conf, device=self.device)
        if self.params_map is not None:
            m.init()
            m.params_map = {n: dict(p) for n, p in self.params_map.items()}
            m.states_map = {n: dict(s) for n, s in self.states_map.items()}
            m.opt_states = dict(self.opt_states)
            if self._loss_scale_state is not None:
                m._loss_scale_state = dict(self._loss_scale_state)
                m._ls_seen = self._ls_seen
        return m

    def getIterationCount(self) -> int:
        return self._iteration

    def getEpochCount(self) -> int:
        return self._epoch

    # ------------------------------------------------------------------
    # stateful stepping
    # ------------------------------------------------------------------
    def _recurrent_nodes(self) -> List[str]:
        return [n.name for n in self.conf.nodes
                if getattr(getattr(n.vertex, "layer", None), "is_recurrent",
                           False)]

    def rnnTimeStep(self, *xs) -> List[torch.Tensor]:
        """One or more timesteps of stateful inference across the graph:
        each recurrent layer vertex keeps its carry between calls (in a
        two-input encoder-decoder both LSTMs advance). 2-D inputs
        ``[N, F]`` are one step and give ``[N, out]``; 3-D ``[N, T, F]``
        step T times. A batch size other than the stored state's raises
        ``ValueError``. Returns one tensor per graph output."""
        self._check_init()
        names = self.conf.network_inputs
        if len(xs) != len(names):
            raise ValueError(f"expected {len(names)} inputs, got {len(xs)}")
        arrs = [self._tensor(x, self._input_dtype) for x in xs]
        single = arrs[0].dim() == 2
        if single:
            arrs = [a[:, None, :] if a.dim() == 2 else a for a in arrs]
        n = arrs[0].shape[0]
        if self._rnn_carries is not None and self._rnn_batch != n:
            raise ValueError(
                f"rnnTimeStep batch size changed ({self._rnn_batch} -> {n}) "
                "with stored state — call rnnClearPreviousState() first "
                "(reference behavior)")
        if self._rnn_carries is None:
            by_name = {node.name: node for node in self.conf.nodes}
            self._rnn_carries = {
                name: by_name[name].vertex.layer.init_carry(
                    n, self._compute_dtypes[name] if self._mixed
                    else self._dtype, self.device)
                for name in self._recurrent_nodes()}
            self._rnn_batch = n
        acts: Dict[str, Any] = dict(zip(names, arrs))
        carries = {}
        with torch.no_grad():
            for node in self.conf.nodes:
                xs_n = self._cast_xs([acts[s] for s in node.inputs],
                                     node.name)
                p = self._cast_p(self.params_map[node.name], node.name)
                st = self.states_map[node.name]
                if node.name in self._rnn_carries:
                    acts[node.name], _, carries[node.name] = \
                        node.vertex.layer.apply_with_carry(
                            p, st, self._rnn_carries[node.name], xs_n[0],
                            False, None)
                else:
                    acts[node.name], _ = node.vertex.apply(p, st, xs_n,
                                                           False, None)
        self._rnn_carries = carries
        outs = [self._cast_out(acts[o]) for o in self.conf.network_outputs]
        if single:
            outs = [o[:, 0] if o.dim() == 3 else o for o in outs]
        return outs

    def rnnClearPreviousState(self) -> None:
        self._rnn_carries = None
        self._rnn_batch = 0

    def rnnGetPreviousState(self, name: str):
        """The stored carry of one recurrent vertex (an LSTM's ``(h,
        c)``), or None."""
        if self._rnn_carries is None:
            return None
        return self._rnn_carries.get(name)

    # ------------------------------------------------------------------
    def backpropGradient(self, xs, external_errors, train: bool = True):
        """Backpropagate external errors, one ``dL/d output`` per graph
        output (in output order), through the forward (training mode:
        dropout and batch statistics, as ``fit`` runs it, unless ``train``
        is False). ``xs`` has one array per graph input. Returns
        ``(gradients in the params_map layout, {input name: epsilon})``.
        A wrong count or shape raises ``ValueError``, and the dropout
        generator is left where it was."""
        self._check_init()
        conf = self.conf
        xs = list(xs) if isinstance(xs, (list, tuple)) else [xs]
        errs = (list(external_errors)
                if isinstance(external_errors, (list, tuple))
                else [external_errors])
        if len(xs) != len(conf.network_inputs):
            raise ValueError(
                f"need one input per network input "
                f"({len(conf.network_inputs)}), got {len(xs)}")
        if len(errs) != len(conf.network_outputs):
            raise ValueError(
                f"need one external error per network output "
                f"({len(conf.network_outputs)}), got {len(errs)}")
        inputs = self._inputs(xs)
        errs = [self._tensor(e, self._out_dtype) for e in errs]

        def forward(params, ins):
            acts, _ = self._forward_all(params, self.states_map, ins, train,
                                        self._generator if train else None)
            outs = [self._cast_out(acts[o]) for o in conf.network_outputs]
            for e, o, name in zip(errs, outs, conf.network_outputs):
                if e.shape != o.shape:
                    raise ValueError(
                        f"external error for output {name!r} has shape "
                        f"{tuple(e.shape)}, expected {tuple(o.shape)}")
            return outs

        return external_gradients(self._generator, forward, self.params_map,
                                  inputs, errs)

    # ------------------------------------------------------------------
    # layerwise unsupervised pretraining
    # ------------------------------------------------------------------
    def _pretrain_step(self, name: str, inputs) -> torch.Tensor:
        """One unsupervised update of layer vertex ``name``: every vertex
        before it in topological order in inference mode without autograd,
        then the layer's pretrain loss on its first input, the gradient,
        normalisation, its updater and its constraints. Returns the loss,
        detached."""
        layer = self._node(name).vertex.layer
        acts = dict(inputs)
        with torch.no_grad():
            for nd in self.conf.nodes:
                if nd.name == name:
                    break
                acts[nd.name], _ = nd.vertex.apply(
                    self._cast_p(self.params_map[nd.name], nd.name),
                    self.states_map[nd.name],
                    self._cast_xs([acts[s] for s in nd.inputs], nd.name),
                    False, None)
        x = acts[self._node(name).inputs[0]]
        p = tree_map(lambda v: v.detach().requires_grad_(True),
                     self.params_map[name])
        with torch.enable_grad():
            loss = pretrain_loss(layer, p, x, self._generator,
                                 lambda q: self._cast_p(q, name),
                                 lambda v: self._cast_xs([v], name)[0])
            g = grads_of(loss, p)
        g = self._clip({name: g})[name]
        with torch.no_grad():
            self.params_map[name], self.opt_states[name] = self._update_one(
                name, self.params_map[name], self.opt_states[name], g,
                self._iteration)
        return loss.detach()

    def pretrainLayer(self, name: str, data, epochs: int = 1):
        """Unsupervised training of layer vertex ``name`` alone; the
        vertices upstream act as a frozen feature extractor. ``data`` is
        features: one array (a single-input graph), a list with one per
        graph input, or a ``DataSet`` / ``MultiDataSet`` or an iterator of
        them (labels ignored). Each update counts an iteration."""
        self._check_init()
        layer = getattr(self._node(name).vertex, "layer", None)
        if layer is None or not hasattr(layer, "unsupervised_loss"):
            raise ValueError(
                f"vertex {name!r} is not pretrainable — only layer "
                "vertices with an unsupervised loss "
                "(VariationalAutoencoder, AutoEncoder) support "
                "pretrainLayer")
        conf = self.conf

        def feature_batches():
            if isinstance(data, (MultiDataSetIterator, DataSetIterator)):
                for d in data:
                    yield (d.features if isinstance(d.features, (list,
                                                                 tuple))
                           else [d.features])
            elif isinstance(data, (MultiDataSet, DataSet)):
                f = data.features
                yield f if isinstance(f, (list, tuple)) else [f]
            elif isinstance(data, (list, tuple)):
                yield data
            else:
                yield [data]

        for _ in range(epochs):
            for xs in feature_batches():
                if len(xs) != len(conf.network_inputs):
                    raise ValueError(
                        f"expected {len(conf.network_inputs)} input "
                        f"arrays, got {len(xs)}")
                self._score = self._pretrain_step(name, self._inputs(xs))
                self._iteration += 1
        return self

    def pretrain(self, data, epochs: int = 1):
        """``pretrainLayer`` of every pretrainable layer vertex, in
        topological order."""
        for node in self.conf.nodes:
            layer = getattr(node.vertex, "layer", None)
            if layer is not None and hasattr(layer, "unsupervised_loss"):
                self.pretrainLayer(node.name, data, epochs)
        return self

    def summary(self) -> str:
        """One row a vertex (name, layer or vertex class, parameter count,
        inputs) and the total, the JAX package's text character for
        character."""
        self._check_init()
        lines = [f"{'name':<24}{'vertex':<26}{'params':>12}  inputs"]
        total = 0
        for node in self.conf.nodes:
            n = sum(int(t.numel()) for t in
                    tree_leaves(self.params_map[node.name]))
            total += n
            vname = (type(node.vertex.layer).__name__
                     if isinstance(node.vertex, LayerVertex)
                     else type(node.vertex).__name__)
            lines.append(f"{node.name:<24}{vname:<26}{n:>12,}  {node.inputs}")
        lines.append(f"Total params: {total:,}")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    def setHealthMonitor(self, monitor) -> "ComputationGraph":
        """Attach (or with None, detach) a
        :class:`~deeplearning4j_tpu_torch.profiler.model_health.HealthMonitor`."""
        self._health = monitor
        return self

    def getHealthMonitor(self):
        return self._health


__all__ = ["ComputationGraph"]
