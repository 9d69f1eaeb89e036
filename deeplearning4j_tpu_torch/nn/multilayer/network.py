"""MultiLayerNetwork: counterpart of
``deeplearning4j_tpu/nn/multilayer/network.py`` for the ported layers.

The JAX network compiles each training step into one XLA program. Here a
step is eager PyTorch: the forward through the layer list, one
``torch.autograd.grad`` into every parameter, the gradient clipping, then
one :func:`~deeplearning4j_tpu_torch.learning.updaters.apply_updater` per
layer (``params - updates`` in each parameter's dtype). An LSTM layer runs
the hand-written recurrence kernels on the card, forward and backward.

Ported: ``init``, ``fit`` (arrays, a ``DataSet`` or a ``DataSetIterator``;
standard BPTT and truncated BPTT, one update per segment with the carries
detached between segments and reset at each minibatch; a features mask
zeroes the padded steps and masks global pooling), ``output``,
``feedForward``, ``rnnTimeStep`` and its state accessors,
``backpropGradient`` (external errors), ``score``, ``evaluate`` and its
ROC and regression variants, the listeners, ``clone``, ``params``,
``numParams``, ``paramTable``, l1/l2 regularization, gradient
normalization, epoch-typed learning-rate schedules and the preprocessor
tags between image and dense layers
(``nn.conf.builder.apply_preprocessor``), the precision policies
(``nn.precision``, below), the layers' weight noise (in training) and
constraints (after each update), frozen layers (``nn.transferlearning``:
their parameters left out of the gradient and the updater), layerwise
pretraining (``pretrainLayer``, ``pretrain``,
``reconstructionLogProbability``) and ``summary``, the fault-tolerant fit
(``fit(fault_tolerance=..., auto_resume=...)``, which hands the loop to
``util.resilience.run_fit``) and the model-health monitor
(``setHealthMonitor``, ``profiler.model_health``).

Under a mixed policy (``conf.precision``) the parameters and the updater
state are the f32 masters (``_dtype``); inputs are staged in the compute
dtype (``_input_dtype``); each layer's parameters and input are cast to
its compute dtype (``_cast_p``, ``_cast_a``: the policy's, or f32 for the
loss head and the normalization layers), recurrent carries are made in
it (``_cd``); and what ``output``, ``feedForward``, ``rnnTimeStep`` and
``backpropGradient`` return is in the output dtype (``_out_dtype``).
Under ``mixed_float16`` a step differentiates the scaled loss, unscales
in f32, judges finiteness before the clipping, updates, and keeps the
old parameters, updater state and layer state where the gradients were
not finite, all on the device (``_loss_scale_state``); the iteration
count advances either way, as in the JAX step.

``fit`` over an iterator takes each batch as it comes: one already on the
device in the input dtype (a ``DevicePrefetchIterator``'s) goes into the
step without a copy, and nothing on the way reads a value back from the
card; ``_last_etl_ms`` is the time the last ``next()`` blocked. Each step
records its phases in ``profiler.telemetry`` (``etl_wait``,
``device_step``, ``listener_host``: host time, the step's dispatch, not
its time on the card) and samples the card's allocator watermarks.

With a health monitor attached, a step also flags each layer's forward
output for NaN and Inf (``collect_acts``) and reduces its gradients,
parameters and update on the card (``model_health.device_stats``); the
monitor reads them back every ``frequency`` steps. Without one, a step
runs none of it.

Parameters are a list of per-layer dicts of tensors in the JAX layout, so
``params.mln_params_from_numpy`` and ``util.model_serializer`` carry a
JAX network's weights across unchanged.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.learning.schedules import uses_epoch_schedule
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, apply_updater
from deeplearning4j_tpu_torch.nn import precision as _precision
from deeplearning4j_tpu_torch.nn.conf.builder import (
    MultiLayerConfiguration, apply_preprocessor, preprocessor_output_type)
from deeplearning4j_tpu_torch.nn.conf.constraint import apply_constraints
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import GlobalPoolingLayer
from deeplearning4j_tpu_torch.nn.masking import validate_features_mask
from deeplearning4j_tpu_torch.ops.transforms import jax_abs
from deeplearning4j_tpu_torch.params import (tree_leaves, tree_map, tree_map2,
                                             tree_unflatten)
from deeplearning4j_tpu_torch.profiler import flight_recorder as _flight
from deeplearning4j_tpu_torch.profiler import model_health as _model_health
from deeplearning4j_tpu_torch.profiler import telemetry as _telemetry

#: param keys subject to l1/l2 (weights, not biases)
_REGULARIZED_KEYS = {"W", "RW", "dW", "pW", "Wq", "Wk", "Wv", "Wo"}

def eval_mask(ds):
    """The labels mask for evaluation: per-timestep labels with a features
    mask and no labels mask take the features mask (the RNN
    convention)."""
    if ds.labels_mask is None and ds.features_mask is not None \
            and ds.labels.ndim == 3:
        return ds.features_mask
    return ds.labels_mask


def fit_epochs(model, iterator, epochs: int, step):
    """``epochs`` passes of ``step(batch)`` over ``iterator``, each wait
    in its ``next()`` in ``model._last_etl_ms`` and the ``etl_wait``
    phase, each pass ending in the epoch count and the listeners'
    ``onEpochEnd``."""
    for _ in range(epochs):
        it = iter(iterator)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            model._last_etl_ms = (time.perf_counter() - t0) * 1e3
            _telemetry.record_phase("etl_wait", t0)
            step(batch)
        model._epoch += 1
        for l in model._listeners:
            if hasattr(l, "onEpochEnd"):
                l.onEpochEnd(model)
    return model


def as_device_tensor(a, device, dtype=None) -> torch.Tensor:
    """``a`` (numpy or tensor) on ``device``; float64 numpy arrays arrive
    as float32, as ``jnp.asarray`` gives them."""
    if not torch.is_tensor(a):
        a = np.asarray(a)
        if a.dtype == np.float64 and dtype is None:
            a = a.astype(np.float32)
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=device, dtype=dtype)


def weight_penalty(layers_params, reg: torch.Tensor) -> torch.Tensor:
    """``reg`` plus each layer's l1 and ``0.5 * l2 * sum(W * W)`` over its
    weights (``_REGULARIZED_KEYS``), for ``(layer, params)`` pairs; the l1
    term takes ``jnp.abs``'s slope 1 at a weight of exactly 0."""
    for layer, p in layers_params:
        l1, l2 = layer.l1 or 0.0, layer.l2 or 0.0
        if l1 == 0.0 and l2 == 0.0:
            continue
        for k, v in p.items():
            if k in _REGULARIZED_KEYS:
                if l1:
                    reg = reg + l1 * torch.sum(jax_abs(v))
                if l2:
                    reg = reg + 0.5 * l2 * torch.sum(v * v)
    return reg


def with_weight_noise(layer, p, generator):
    """``p`` with ``layer``'s weight noise, where it has one and there is
    a generator (a training forward)."""
    wn = getattr(layer, "weight_noise", None)
    if wn is not None and generator is not None:
        return wn.apply(p, generator)
    return p


def trainable_leaves(params, frozen):
    """The gradient's leaves: each entry of ``params`` (a list or a dict
    of per-layer trees) detached and requiring grad, an empty tree where
    ``frozen(key)`` is true, so ``grads_of`` never visits a frozen
    parameter."""
    keys = range(len(params)) if isinstance(params, list) else params
    out = {k: {} if frozen(k) else tree_map(
        lambda v: v.detach().requires_grad_(True), params[k]) for k in keys}
    return [out[k] for k in keys] if isinstance(params, list) else out


def merged(trainable, params, frozen):
    """``trainable`` with each frozen entry taken from ``params``."""
    keys = range(len(params)) if isinstance(params, list) else params
    out = {k: params[k] if frozen(k) else trainable[k] for k in keys}
    return [out[k] for k in keys] if isinstance(params, list) else out


def pretrain_loss(layer, p, x, generator, cast_p, cast_x):
    """One pretrain step's loss of ``layer`` on its input ``x``: the
    layer's weight noise, its ``unsupervised_loss`` on the parameters and
    input in its compute dtype (``cast_p``, ``cast_x``), and its l1 / l2
    terms on the master parameters (after the noise, as the JAX step
    reads them)."""
    p = with_weight_noise(layer, p, generator)
    loss = layer.unsupervised_loss(cast_p(p), cast_x(x), generator)
    return weight_penalty([(layer, p)], loss)


def _feature_batches(data):
    """The feature arrays of ``data`` for pretraining (labels ignored): a
    ``DataSetIterator``'s batches, a ``DataSet``'s features, or ``data``
    itself."""
    if isinstance(data, DataSetIterator):
        for ds in data:
            yield ds.features
    elif isinstance(data, DataSet):
        yield data.features
    else:
        yield data


def normalize_gradients(mode: Optional[str], t: float, g: dict) -> dict:
    """One layer's gradients under the configuration's gradient
    normalization (``mode`` None leaves them); the L2 norms are summed in
    the gradients' dtype, as the JAX step does."""
    if not mode or not tree_leaves(g):
        return g
    if mode == "ClipElementWiseAbsoluteValue":
        return tree_map(lambda l: torch.clamp(l, -t, t), g)
    if mode not in ("ClipL2PerLayer", "RenormalizeL2PerLayer"):
        raise ValueError(f"Unknown gradient normalization: {mode}")
    norm = torch.sqrt(sum(torch.sum(l * l) for l in tree_leaves(g)) + 1e-12)
    if mode == "ClipL2PerLayer":
        scale = torch.clamp(t / norm, max=1.0)
        return tree_map(lambda l: l * scale, g)
    return tree_map(lambda l: l / norm, g)


def grads_of(loss: torch.Tensor, leaves):
    """``d loss / d leaves``: the gradient of every leaf of the tree
    ``leaves`` (tensors that require grad), in its structure, zero where
    the loss does not reach a leaf, as ``jax.grad`` gives it."""
    flat = tree_leaves(leaves)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    return tree_unflatten(leaves, [torch.zeros_like(v) if g is None else g
                                   for g, v in zip(got, flat)])


def external_gradients(generator, forward, params, inputs, errs):
    """``(parameter gradients, input epsilons)`` of external errors:
    ``forward(params, inputs)`` gives the outputs (a list), and ``errs``
    (one per output) are backpropagated through it into the parameter
    tree ``params`` and the input tree ``inputs`` (a float input gets its
    epsilon, any other a zero). ``forward`` raises ``ValueError`` on an
    error of the wrong shape; ``generator``'s state (dropout) is then put
    back as it was."""
    saved = generator.get_state() if generator is not None else None
    leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
    ins = tree_map(lambda x: x.detach().requires_grad_(
        x.is_floating_point()), inputs)
    try:
        with torch.enable_grad():
            outs = forward(leaves, ins)
    except ValueError:
        if saved is not None:
            generator.set_state(saved)
        raise
    wrt = tree_leaves(leaves) + [x for x in tree_leaves(ins)
                                 if x.requires_grad]
    got = list(torch.autograd.grad(outs, wrt, grad_outputs=errs,
                                   allow_unused=True))
    got = [torch.zeros_like(v) if g is None else g for g, v in zip(got, wrt)]
    n = len(tree_leaves(leaves))
    grads, rest = tree_unflatten(leaves, got[:n]), iter(got[n:])
    eps = tree_map(lambda x: next(rest) if x.requires_grad
                   else torch.zeros_like(x), ins)
    return grads, eps


class MultiLayerNetwork:
    """A sequential network on one device: the CUDA card unless the
    caller passes ``device="cpu"`` (without a card and without a device
    it raises)."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self._policy = _precision.PrecisionPolicy.resolve(
            getattr(conf, "precision", None), conf.dtype)
        self._mixed = not self._policy.is_identity
        #: the master dtype of parameters and updater state
        self._dtype = _precision.torch_dtype(self._policy.param_dtype)
        #: the dtype inputs are staged in (the compute dtype)
        self._input_dtype = _precision.torch_dtype(self._policy.compute_dtype)
        #: the dtype output() and its siblings return
        self._out_dtype = _precision.torch_dtype(self._policy.output_dtype)
        self._compute_dtypes: List[torch.dtype] = []
        self._loss_scale_state = None
        self._ls_seen = (0, 0)
        self.params_list: Optional[List[dict]] = None
        self.states_list: Optional[List[dict]] = None
        self.opt_states: Optional[List[Any]] = None
        self._updaters: List[IUpdater] = []
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")
        self._rnn_carries = None
        self._rnn_batch = 0
        self._generator: Optional[torch.Generator] = None
        self._listeners: List[Any] = []
        self._last_etl_ms: Optional[float] = None
        self._last_batch_size = 0
        #: the model-health monitor (profiler/model_health.py), or None
        self._health = None

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def init(self) -> "MultiLayerNetwork":
        """Parameters from a ``torch.Generator`` seeded with
        ``conf.seed`` (not the JAX draws), zero updater state, and the
        dropout generator."""
        conf = self.conf
        gen = torch.Generator().manual_seed(int(conf.seed))
        it = conf.input_type or self._infer_input_type()
        self.params_list, self.states_list, self._updaters = [], [], []
        self.opt_states = []
        for i, layer in enumerate(conf.layers):
            tag = conf.preprocessors.get(i)
            if tag:
                it = preprocessor_output_type(tag, it)
            elif it.kind == "convolutionalFlat":
                it = InputType.feedForward(it.flat_size())
            p = layer.init_params(gen, it, self._dtype, self.device)
            s = layer.init_state(it, self._dtype, self.device)
            upd = layer.updater if layer.updater is not None else conf.updater
            self.params_list.append(p)
            self.states_list.append(s)
            self._updaters.append(upd)
            self.opt_states.append(upd.init_state(p))
            it = layer.output_type(it)
        self._output_type = it
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(conf.seed) ^ 0x5EED)
        self._compute_dtypes = [self._policy.layer_compute_dtype(l, i)
                                for i, l in enumerate(conf.layers)]
        self._loss_scale_state = _precision.init_loss_scale(
            self._policy, self.device)
        self._ls_seen = (0, 0)
        if self._mixed:
            _precision.record_cast_count("mln", sum(
                _precision.count_casts(p, self._compute_dtypes[i])
                for i, p in enumerate(self.params_list)))
        return self

    def _infer_input_type(self) -> InputType:
        from deeplearning4j_tpu_torch.nn.conf.layers import LSTM, SimpleRnn

        first = self.conf.layers[0]
        n_in = getattr(first, "n_in", 0)
        if not n_in:
            raise ValueError(
                "Without setInputType, the first layer must declare n_in")
        if isinstance(first, (LSTM, SimpleRnn)):
            return InputType.recurrent(n_in)
        return InputType.feedForward(n_in)

    def _check_init(self):
        if self.params_list is None:
            raise RuntimeError("Call init() first")

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return as_device_tensor(a, self.device, dtype)

    # ------------------------------------------------------------------
    # the mixed-precision seams (no-ops under a single-dtype policy)
    # ------------------------------------------------------------------
    def _cd(self, i: int) -> torch.dtype:
        """Layer ``i``'s compute dtype."""
        return self._compute_dtypes[i] if self._mixed else self._dtype

    def _cast_p(self, p, i: int):
        """Layer ``i``'s master parameters in its compute dtype; autograd
        takes the gradients back to the masters' dtype through the
        cast."""
        return _precision.cast_tree(p, self._compute_dtypes[i]) \
            if self._mixed else p

    def _cast_a(self, a, i: int):
        """The activation entering layer ``i`` in its compute dtype (an
        f32 island casts up; the next reduced-precision layer casts
        down)."""
        return _precision.cast_leaf(a, self._compute_dtypes[i]) \
            if self._mixed else a

    def _cast_out(self, a):
        return _precision.cast_leaf(a, self._out_dtype) if self._mixed else a

    # ------------------------------------------------------------------
    # forward and loss
    # ------------------------------------------------------------------
    def _forward(self, params_list, states_list, x, train: bool, generator,
                 fmask=None):
        """Forward through all layers: ``(out, new_states)``. A features
        mask zeroes the padded steps of ``x`` and masks global pooling
        while the time axis still lines up."""
        a = x
        if fmask is not None:
            a = a * fmask[..., None].to(a.dtype)
        new_states = []
        for i, layer in enumerate(self.conf.layers):
            a = self._cast_a(self._preprocess(i, a), i)
            p = self._cast_p(params_list[i], i)
            if _pools_masked(layer, a, fmask):
                a, ns = layer.apply_masked(p, states_list[i], a, fmask,
                                           train, generator)
            else:
                a, ns = layer.apply(p, states_list[i], a, train, generator)
            new_states.append(ns)
        return self._cast_out(a), new_states

    def _preprocess(self, i: int, a):
        """Layer ``i``'s input after its preprocessor, if it has one."""
        tag = self.conf.preprocessors.get(i)
        return apply_preprocessor(tag, a) if tag else a

    def _loss_carries(self, params_list, states_list, carries, x, y, mask,
                      generator, fmask=None, collect_acts=False):
        """Training-mode forward to the loss head, threading recurrent
        carries when given (truncated BPTT). Returns ``(loss, (new_states,
        data_loss, new_carries))``; ``loss`` adds the l1/l2 terms. With
        ``collect_acts`` (a monitored step) the aux ends in the per-layer
        non-finite flags: each layer's output, the head's loss value."""
        conf = self.conf
        a = x
        if fmask is not None:
            a = a * fmask[..., None].to(a.dtype)
        new_states, new_carries = [], []
        act_bad = [] if collect_acts else None
        for i, layer in enumerate(conf.layers[:-1]):
            a = self._cast_a(self._preprocess(i, a), i)
            p = self._cast_p(params_list[i], i)
            if _pools_masked(layer, a, fmask):
                a, ns = layer.apply_masked(p, states_list[i], a, fmask, True,
                                           generator)
                new_states.append(ns)
                new_carries.append(None)
                if collect_acts:
                    act_bad.append(_model_health.act_flag(a))
                continue
            p = with_weight_noise(layer, p, generator)
            if carries is not None and layer.is_recurrent:
                a, ns, c = layer.apply_with_carry(
                    p, states_list[i], carries[i], a, True, generator)
            else:
                a, ns = layer.apply(p, states_list[i], a, True, generator)
                c = None
            new_states.append(ns)
            new_carries.append(c)
            if collect_acts:
                act_bad.append(_model_health.act_flag(a))
        new_carries.append(None)        # the loss head is never recurrent
        last = conf.layers[-1]
        if not hasattr(last, "loss_value"):
            raise ValueError("Last layer must be an OutputLayer to fit()")
        # the loss head: an f32 island under the mixed policies, so the
        # logits, the softmax and the reduction run at f32
        k = len(conf.layers) - 1
        a = self._cast_a(self._preprocess(k, a), k)
        data_loss = last.loss_value(
            with_weight_noise(last, self._cast_p(params_list[-1], k),
                              generator), states_list[-1], a, y, mask)
        new_states.append(states_list[-1])
        reg = weight_penalty(zip(conf.layers, params_list), torch.zeros(
            (), dtype=data_loss.dtype, device=data_loss.device))
        if collect_acts:
            act_bad.append(_model_health.act_flag(data_loss))
            return data_loss + reg, (new_states, data_loss, new_carries,
                                     act_bad)
        return data_loss + reg, (new_states, data_loss, new_carries)

    def _clip_grads(self, grads_list):
        conf = self.conf
        return [normalize_gradients(conf.gradient_normalization,
                                    conf.gradient_normalization_threshold, g)
                for g in grads_list]

    def _frozen(self, i: int) -> bool:
        """Whether layer ``i``'s parameters are frozen (a ``FrozenLayer``
        or ``FrozenLayerWithBackprop``)."""
        return getattr(self.conf.layers[i], "frozen_params", False)

    def _update_one(self, i: int, p, opt_state, g, step: int):
        """Layer ``i``'s parameters after one ``apply_updater`` at ``step``
        (``p - u`` in the parameter's dtype) and its constraints; a frozen
        layer is left as it is. Returns ``(params, updater state)``."""
        layer = self.conf.layers[i]
        if self._frozen(i):
            return apply_constraints(layer, p), opt_state
        updates, no = apply_updater(self._updaters[i], opt_state, g, p, step)
        return apply_constraints(layer, tree_map2(lambda a, u: a - u, p,
                                                  updates)), no

    def _apply_updates(self, params_list, opt_states, grads):
        """One update per layer at the iteration count (the epoch count
        for an epoch-typed schedule)."""
        new_params, new_opt = [], []
        for i, p in enumerate(params_list):
            step = (self._epoch if uses_epoch_schedule(self._updaters[i])
                    else self._iteration)
            np_i, no = self._update_one(i, p, opt_states[i], grads[i], step)
            new_params.append(np_i)
            new_opt.append(no)
        return new_params, new_opt

    def _train_step(self, x, y, mask, fmask, carries):
        """One update: forward, gradients of every parameter that is not
        frozen, clipping, updater; under loss scaling the skip-step guard.
        Returns ``(data_loss, new_carries, health)``, the first two
        detached, ``health`` the on-card health dict of a monitored step
        (None without a monitor)."""
        monitored = self._health is not None
        leaves = trainable_leaves(self.params_list, self._frozen)

        def loss_fn(pl):
            return self._loss_carries(
                merged(pl, self.params_list, self._frozen), self.states_list,
                carries, x, y, mask, self._generator, fmask,
                collect_acts=monitored)

        ls = self._loss_scale_state
        if ls is not None:
            # carries are not guarded: they are activations, and the
            # next minibatch resets them
            (_, aux), grads, finite = _precision.scaled_value_and_grad(
                loss_fn, ls, leaves)
        else:
            with torch.enable_grad():
                loss, aux = loss_fn(leaves)
                grads = grads_of(loss, leaves)
        new_states, data_loss, new_carries = aux[:3]
        del leaves
        raw_grads = grads
        grads = self._clip_grads(grads)
        with torch.no_grad():
            new_params, new_opt = self._apply_updates(
                self.params_list, self.opt_states, grads)
            if ls is not None:
                (new_params, new_opt, new_states,
                 self._loss_scale_state) = _precision.guard_scaled_step(
                    self._policy, ls, finite,
                    [(new_params, self.params_list),
                     (new_opt, self.opt_states),
                     (new_states, self.states_list)])
            health = None
            if monitored:
                # after the guard: a skipped step reads update ratio 0,
                # and the handled bit keeps it from reading as sickness
                health = _model_health.device_stats(
                    range(len(self.conf.layers)), raw_grads, new_params,
                    self.params_list, aux[3],
                    handled=None if ls is None else torch.logical_not(finite),
                    device=self.device)
        self.params_list, self.opt_states = new_params, new_opt
        self.states_list = new_states
        # an LSTM's carry is (h, c), a SimpleRnn's h alone
        detached = [None if c is None else c.detach() if torch.is_tensor(c)
                    else tuple(t.detach() for t in c) for c in new_carries]
        return data_loss.detach(), detached, health

    def _monitored_step(self, site: str, x, y, mask, fmask, carries):
        """:meth:`_train_step` timed as the ``device_step`` phase; under a
        health monitor the first step of each input signature runs under
        :func:`~deeplearning4j_tpu_torch.profiler.model_health.counting_flops`
        and every step is charged its count."""
        hm = self._health
        t_step = time.perf_counter()
        if hm is None:
            out = self._train_step(x, y, mask, fmask, carries)
        else:
            sig = _model_health.step_signature(x, y, mask, fmask)
            if hm.wants_flops(site, sig):
                with _model_health.counting_flops() as box:
                    out = self._train_step(x, y, mask, fmask, carries)
                hm.record_flops(site, sig, box["flops"])
            else:
                out = self._train_step(x, y, mask, fmask, carries)
            hm.charge_flops(site, sig)
        _telemetry.record_phase("device_step", t_step)
        return out + (t_step,)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1, fault_tolerance=None,
            auto_resume=None):
        """Train on arrays ``fit(x, y)`` or a ``DataSet`` (``epochs``
        passes over the one batch), or on a ``DataSetIterator``
        (``epochs`` passes, each ending in the listeners'
        ``onEpochEnd``). A ``FaultTolerance`` policy, or an
        ``auto_resume`` directory, runs the guarded loop of
        ``util.resilience`` instead (preemption bundles, auto-resume,
        divergence rollback, the watchdog, transfer retries)."""
        self._check_init()
        if fault_tolerance is not None or auto_resume is not None:
            from deeplearning4j_tpu_torch.util import resilience

            return resilience.run_fit(self, fault_tolerance, data, labels,
                                      epochs, auto_resume=auto_resume)
        if isinstance(data, DataSetIterator):
            return fit_epochs(self, data, epochs, lambda ds: self._fit_batch(
                ds.features, ds.labels, ds.labels_mask, ds.features_mask))
        self._last_etl_ms = None
        if isinstance(data, DataSet):
            for _ in range(epochs):
                self._fit_batch(data.features, data.labels, data.labels_mask,
                                data.features_mask)
            return self
        if not (torch.is_tensor(data) or isinstance(data, np.ndarray)):
            raise TypeError(
                f"fit({type(data).__name__}): expected arrays, a DataSet or "
                f"a DataSetIterator")
        if labels is None:
            raise ValueError("fit(x, y) requires labels")
        for _ in range(epochs):
            self._fit_batch(data, labels, None)
        return self

    def _fit_batch(self, x, y, mask, features_mask=None):
        if torch.is_tensor(x) and x.device == self.device \
                and x.dtype == self._input_dtype:
            _telemetry.record_on_device_batch("mln")
        x = self._tensor(x, self._input_dtype)
        y = self._tensor(y)
        fm = validate_features_mask(features_mask, x)
        # per-timestep labels with a features mask and no label mask: the
        # features mask is the label mask
        if mask is None and fm is not None and y.dim() == 3 \
                and fm.dim() == 2 and y.shape[1] == fm.shape[1]:
            mask = fm
        m = self._tensor(mask) if mask is not None else None
        k = self.conf.tbptt_fwd_length
        if (k and x.dim() == 3 and x.shape[1] > k
                and any(l.is_recurrent for l in self.conf.layers)):
            if fm is not None:
                raise NotImplementedError(
                    "features masks with truncated BPTT are not supported "
                    "yet; use standard BPTT")
            return self._fit_tbptt(x, y, m, k)
        self._score, _, health, t_step = self._monitored_step(
            "mln_step", x, y, m, fm, None)
        self._after_step(x, health, "mln_step", t_step)

    def _after_step(self, x, health, site: str, t_step: float) -> None:
        """Count the update (a skipped one too), record it (flight
        recorder, memory watermarks, the health monitor, the loss-scale
        series) and tell the listeners."""
        self._iteration += 1
        self._last_batch_size = int(x.shape[0])
        _flight.record_step(site.replace("_step", ""), self._iteration,
                            t_step, etl_ms=self._last_etl_ms)
        _telemetry.sample_device_memory(self.device)
        if self._health is not None:
            self._health.on_step(self, health, site="mln", jit_site=site)
        if self._loss_scale_state is not None:
            self._ls_seen = _precision.record_loss_scale(
                "mln", self._loss_scale_state, self._ls_seen)
        if self._listeners:
            t_l = time.perf_counter()
            for l in self._listeners:
                l.iterationDone(self, self._iteration, self._epoch)
            _telemetry.record_phase("listener_host", t_l)

    def _fit_tbptt(self, x, y, mask, k: int):
        """Truncated BPTT: segments of ``k`` timesteps, one update per
        segment, the recurrent state carried forward (detached, so no
        gradient crosses a segment) and reset at each minibatch; the
        iteration count (Adam's step) advances per segment."""
        if y.dim() < 3:
            raise ValueError("tBPTT requires per-timestep labels [N,T,C] "
                             "(use RnnOutputLayer)")
        n, t = x.shape[0], x.shape[1]
        try:
            # carries are activations: in the layer's compute dtype
            carries = [(l.init_carry(n, self._cd(i), self.device)
                        if l.is_recurrent else None)
                       for i, l in enumerate(self.conf.layers)]
        except NotImplementedError:
            raise ValueError(
                "Truncated BPTT is not supported with Bidirectional layers "
                "(the backward direction needs the full sequence) — use "
                "standard BPTT") from None
        for t0 in range(0, t, k):
            mc = mask[:, t0:t0 + k] if mask is not None else None
            self._score, carries, health, t_step = self._monitored_step(
                "mln_tbptt_step", x[:, t0:t0 + k], y[:, t0:t0 + k], mc, None,
                carries)
            self._after_step(x, health, "mln_tbptt_step", t_step)

    # ------------------------------------------------------------------
    # layerwise unsupervised pretraining
    # ------------------------------------------------------------------
    def _prefix_activations(self, idx: int, x):
        """The input of layer ``idx``: an inference-mode forward through
        layers ``[0, idx)`` without autograd, then layer ``idx``'s
        preprocessor."""
        a = x
        with torch.no_grad():
            for j, layer in enumerate(self.conf.layers[:idx]):
                a = self._cast_a(self._preprocess(j, a), j)
                a, _ = layer.apply(self._cast_p(self.params_list[j], j),
                                   self.states_list[j], a, False, None)
        return self._preprocess(idx, a)

    def _pretrain_step(self, idx: int, x) -> torch.Tensor:
        """One unsupervised update of layer ``idx`` on the features
        ``x``: the prefix's activations, the layer's pretrain loss and its
        gradient, gradient normalisation, the layer's updater (its own
        state in ``opt_states[idx]``, at the iteration count) and its
        constraints. Returns the loss, detached."""
        layer = self.conf.layers[idx]
        a = self._prefix_activations(idx, x)
        p = tree_map(lambda v: v.detach().requires_grad_(True),
                     self.params_list[idx])
        with torch.enable_grad():
            loss = pretrain_loss(layer, p, a, self._generator,
                                 lambda q: self._cast_p(q, idx),
                                 lambda v: self._cast_a(v, idx))
            g = grads_of(loss, p)
        g = self._clip_grads([g])[0]
        with torch.no_grad():
            self.params_list[idx], self.opt_states[idx] = self._update_one(
                idx, self.params_list[idx], self.opt_states[idx], g,
                self._iteration)
        return loss.detach()

    def pretrainLayer(self, idx: int, data, epochs: int = 1):
        """Unsupervised training of layer ``idx`` alone: the layers below
        act as a frozen feature extractor (inference mode, no autograd),
        and only layer ``idx``'s parameters and updater state change, one
        update per batch of ``data`` (features: an array, a ``DataSet`` or
        a ``DataSetIterator``; labels are ignored). Each update counts an
        iteration; ``score()`` is the last loss with its l1/l2 terms."""
        self._check_init()
        layer = self.conf.layers[idx]
        if not hasattr(layer, "unsupervised_loss"):
            raise ValueError(
                f"layer {idx} ({type(layer).__name__}) is not "
                "pretrainable — only layers with an unsupervised loss "
                "(VariationalAutoencoder, AutoEncoder) support "
                "pretrainLayer")
        for _ in range(epochs):
            for xb in _feature_batches(data):
                x = self._tensor(xb, self._input_dtype)
                self._score = self._pretrain_step(idx, x)
                self._iteration += 1
        return self

    def pretrain(self, data, epochs: int = 1):
        """``pretrainLayer`` of every pretrainable layer, bottom up."""
        for idx, layer in enumerate(self.conf.layers):
            if hasattr(layer, "unsupervised_loss"):
                self.pretrainLayer(idx, data, epochs)
        return self

    def reconstructionLogProbability(self, idx: int, x,
                                     num_samples: int = 16):
        """The importance-sampled ``log p(x)`` per example of the
        ``VariationalAutoencoder`` at layer ``idx`` (the anomaly score),
        on the device, ``[N]``."""
        self._check_init()
        layer = self.conf.layers[idx]
        if not hasattr(layer, "reconstruction_log_prob"):
            raise ValueError(f"layer {idx} is not a "
                             "VariationalAutoencoder")
        a = self._prefix_activations(idx, self._tensor(x, self._input_dtype))
        with torch.no_grad():
            return layer.reconstruction_log_prob(
                self.params_list[idx], a, self._generator, num_samples)

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def output(self, x, train: bool = False, features_mask=None):
        """The network's output for ``x`` (a tensor on the device);
        ``train=True`` applies dropout."""
        self._check_init()
        xt = self._tensor(x, self._input_dtype)
        fm = validate_features_mask(features_mask, xt)
        with torch.no_grad():
            out, _ = self._forward(self.params_list, self.states_list, xt,
                                   train, self._generator if train else None,
                                   fm)
        return out

    def feedForward(self, x) -> List[torch.Tensor]:
        """The input and every layer's output, in inference mode."""
        self._check_init()
        a = self._tensor(x, self._input_dtype)
        acts = [a]
        with torch.no_grad():
            for i, layer in enumerate(self.conf.layers):
                a, _ = layer.apply(self._cast_p(self.params_list[i], i),
                                   self.states_list[i],
                                   self._cast_a(self._preprocess(i, a), i),
                                   False, None)
                acts.append(a)
        acts[-1] = self._cast_out(acts[-1])
        return acts

    def backpropGradient(self, x, external_errors, train: bool = True,
                         features_mask=None):
        """Backpropagate an external error ``dL/d output`` through the
        network's forward (training mode: dropout and batch statistics,
        unless ``train`` is False): ``(gradients in the params_list
        layout, epsilon at the input)``. An error of another shape than
        the output raises ``ValueError`` and leaves the dropout generator
        where it was."""
        self._check_init()
        xt = self._tensor(x, self._input_dtype)
        err = self._tensor(external_errors, self._out_dtype)
        fm = validate_features_mask(features_mask, xt)

        def forward(params, xx):
            out, _ = self._forward(params, self.states_list, xx, train,
                                   self._generator if train else None, fm)
            if err.shape != out.shape:
                raise ValueError(
                    f"external_errors shape {tuple(err.shape)} must match "
                    f"the network output shape {tuple(out.shape)}")
            return [out]

        return external_gradients(self._generator, forward,
                                  self.params_list, xt, [err])

    def rnnTimeStep(self, x):
        """One or more timesteps of stateful inference: the hidden state is
        kept across calls. 2-D input ``[N, F]`` is one step and returns
        ``[N, out]``; 3-D ``[N, T, F]`` steps T times and returns
        ``[N, T, out]``. A batch size other than the stored state's
        raises ``ValueError``."""
        self._check_init()
        xt = self._tensor(x, self._input_dtype)
        single = xt.dim() == 2
        if single:
            xt = xt[:, None, :]
        n = xt.shape[0]
        if self._rnn_carries is not None and self._rnn_batch != n:
            raise ValueError(
                f"rnnTimeStep batch size changed ({self._rnn_batch} -> {n}) "
                "with stored state; call rnnClearPreviousState() first")
        if self._rnn_carries is None:
            self._rnn_carries = [
                (l.init_carry(n, self._cd(i), self.device)
                 if l.is_recurrent else None)
                for i, l in enumerate(self.conf.layers)]
            self._rnn_batch = n
        a = xt
        carries = []
        with torch.no_grad():
            for i, layer in enumerate(self.conf.layers):
                a = self._cast_a(self._preprocess(i, a), i)
                p = self._cast_p(self.params_list[i], i)
                if layer.is_recurrent:
                    a, _, c = layer.apply_with_carry(
                        p, self.states_list[i], self._rnn_carries[i], a,
                        False, None)
                else:
                    a, _ = layer.apply(p, self.states_list[i], a, False, None)
                    c = None
                carries.append(c)
        self._rnn_carries = carries
        a = self._cast_out(a)
        return a[:, 0] if single and a.dim() == 3 else a

    def rnnClearPreviousState(self) -> None:
        self._rnn_carries = None
        self._rnn_batch = 0

    def rnnGetPreviousState(self, layer_idx: int):
        """Stored ``(h, c)`` of one LSTM layer, or None."""
        if self._rnn_carries is None:
            return None
        return self._rnn_carries[layer_idx]

    def rnnSetPreviousState(self, layer_idx: int, state) -> None:
        if self._rnn_carries is None:
            raise RuntimeError("No rnnTimeStep state yet: step once or set "
                               "all layers explicitly")
        self._rnn_carries[layer_idx] = state

    def score(self, dataset: Optional[DataSet] = None) -> float:
        """The last minibatch's loss (without the l1/l2 terms), or the
        loss (with them) on ``dataset``."""
        if dataset is None:
            return float(self._score)
        self._check_init()
        x = self._tensor(dataset.features, self._input_dtype)
        y = self._tensor(dataset.labels)
        m = (self._tensor(dataset.labels_mask)
             if dataset.labels_mask is not None else None)
        with torch.no_grad():
            loss, _ = self._loss_carries(self.params_list, self.states_list,
                                         None, x, y, m, None)
        return float(loss)

    def _evaluate(self, ev, iterator):
        """``ev.eval`` over ``iterator``'s batches of the network's
        inference output (the counts stay on the device)."""
        for ds in iterator:
            out = self.output(ds.features, features_mask=ds.features_mask)
            ev.eval(ds.labels, out, mask=eval_mask(ds))
        return ev

    def evaluate(self, iterator, batch_output=None):
        """Classification ``Evaluation`` over ``iterator``."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation

        return self._evaluate(Evaluation(), iterator)

    def evaluateROC(self, iterator, threshold_steps=0):
        """Binary ``ROC`` (a 1- or 2-column probability output; the sweep
        is exact whatever ``threshold_steps`` says)."""
        from deeplearning4j_tpu_torch.evaluation import ROC

        return self._evaluate(ROC(), iterator)

    def evaluateROCMultiClass(self, iterator, threshold_steps=0):
        """One-vs-all ``ROCMultiClass`` (exact sweep)."""
        from deeplearning4j_tpu_torch.evaluation import ROCMultiClass

        return self._evaluate(ROCMultiClass(), iterator)

    def evaluateRegression(self, iterator):
        from deeplearning4j_tpu_torch.evaluation import RegressionEvaluation

        return self._evaluate(RegressionEvaluation(), iterator)

    # ------------------------------------------------------------------
    # parameter access
    # ------------------------------------------------------------------
    def _flat_order(self):
        return [(i, k) for i, p in enumerate(self.params_list)
                for k in sorted(p)]

    def params(self) -> torch.Tensor:
        """One flat vector of every parameter (a copy), layer by layer,
        keys sorted."""
        self._check_init()
        parts = [self.params_list[i][k].reshape(-1)
                 for i, k in self._flat_order()]
        return torch.cat(parts) if parts else torch.zeros(0,
                                                           device=self.device)

    def numParams(self) -> int:
        self._check_init()
        return sum(int(t.numel()) for t in tree_leaves(self.params_list))

    def paramTable(self) -> dict:
        """``{"0_W": tensor, ...}``."""
        self._check_init()
        return {f"{i}_{k}": self.params_list[i][k]
                for i, k in self._flat_order()}

    def summary(self) -> str:
        """One row a layer (index, class, parameter count, output type)
        and the total, the JAX package's text character for character."""
        self._check_init()
        lines = [f"{'idx':<4}{'layer':<28}{'params':>12}  out_type"]
        it = self.conf.input_type
        total = 0
        for i, layer in enumerate(self.conf.layers):
            n = sum(int(t.numel()) for t in tree_leaves(self.params_list[i]))
            total += n
            ot = layer.output_type(it) if it else None
            lines.append(f"{i:<4}{type(layer).__name__:<28}{n:>12,}  "
                         f"{(ot.kind + str(ot.example_shape())) if ot else '?'}")
            it = ot
        lines.append(f"Total params: {total:,}")
        return "\n".join(lines)

    def clone(self) -> "MultiLayerNetwork":
        """A network of the same configuration on the same device sharing
        this one's tensors (a step replaces tensors, it does not write
        into them), the loss-scale state included; its counters and
        dropout generator start afresh, as the JAX clone's do."""
        m = MultiLayerNetwork(self.conf, device=self.device)
        if self.params_list is not None:
            m.init()
            m.params_list = [dict(p) for p in self.params_list]
            m.states_list = [dict(s) for s in self.states_list]
            m.opt_states = list(self.opt_states)
            if self._loss_scale_state is not None:
                m._loss_scale_state = dict(self._loss_scale_state)
                m._ls_seen = self._ls_seen
        return m

    # ------------------------------------------------------------------
    # listeners
    # ------------------------------------------------------------------
    def setListeners(self, *listeners):
        self._listeners = list(listeners)
        return self

    def addListeners(self, *listeners):
        self._listeners.extend(listeners)
        return self

    def getListeners(self):
        return list(self._listeners)

    def setHealthMonitor(self, monitor) -> "MultiLayerNetwork":
        """Attach (or with None, detach) a
        :class:`~deeplearning4j_tpu_torch.profiler.model_health.HealthMonitor`."""
        self._health = monitor
        return self

    def getHealthMonitor(self):
        return self._health

    def getIterationCount(self) -> int:
        return self._iteration

    def getEpochCount(self) -> int:
        return self._epoch


def _pools_masked(layer, a, fmask) -> bool:
    """Global pooling over a sequence whose time axis still lines up with
    the features mask, which pools over the real steps only."""
    return (fmask is not None and isinstance(layer, GlobalPoolingLayer)
            and a.dim() == 3 and a.shape[1] == fmask.shape[1])


__all__ = ["MultiLayerNetwork", "as_device_tensor",
           "weight_penalty", "normalize_gradients", "eval_mask",
           "fit_epochs", "grads_of", "external_gradients",
           "with_weight_noise", "trainable_leaves", "merged",
           "pretrain_loss"]
