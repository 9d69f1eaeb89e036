"""MultiLayerNetwork: counterpart of
``deeplearning4j_tpu/nn/multilayer/network.py`` for the ported layers.

The JAX network compiles each training step into one XLA program. Here a
step is eager PyTorch: the forward through the layer list, one
``torch.autograd.grad`` into every parameter, the gradient clipping, then
one :func:`~deeplearning4j_tpu_torch.learning.updaters.apply_updater` per
layer (``params - updates`` in each parameter's dtype). An LSTM layer runs
the hand-written recurrence kernels on the card, forward and backward.

Ported: ``init``, ``fit`` (arrays or a ``DataSet``; standard BPTT and
truncated BPTT, one update per segment with the carries detached between
segments and reset at each minibatch), ``output``, ``rnnTimeStep`` and its
state accessors, ``score``, ``params``, ``numParams``, ``paramTable``,
l1/l2 regularization and gradient normalization. Not ported yet, and
raising ``NotImplementedError`` with the ROADMAP item:
listeners, the health monitor, fault tolerance, evaluation and
``DataSetIterator`` (A9), layerwise pretraining (A3), mixed precision
(A2, at the configuration).

Parameters are a list of per-layer dicts of tensors in the JAX layout, so
``params.mln_params_from_numpy`` and ``util.model_serializer`` carry a
JAX network's weights across unchanged.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.learning.updaters import IUpdater, apply_updater
from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.params import tree_map

#: param keys subject to l1/l2 (weights, not biases)
_REGULARIZED_KEYS = {"W", "RW", "dW", "pW", "Wq", "Wk", "Wv", "Wo"}

_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "float64": torch.float64,
    "f32": torch.float32, "fp32": torch.float32, "single": torch.float32,
    "bf16": torch.bfloat16, "f16": torch.float16, "fp16": torch.float16,
    "half": torch.float16, "f64": torch.float64, "fp64": torch.float64,
    "double": torch.float64,
}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a configuration's ``dtype`` string (the JAX
    ``DataType`` values and their short aliases)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name).strip().lower()]
    except KeyError:
        raise ValueError(f"Unsupported dtype: {name!r}") from None


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to deeplearning4j_tpu_torch yet "
        f"(ROADMAP.md {item})")


class MultiLayerNetwork:
    """A sequential network on one device: the CUDA card unless the
    caller passes ``device="cpu"`` (without a card and without a device
    it raises)."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.device = resolve_device(device)
        self._dtype = torch_dtype(conf.dtype)
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
        for layer in conf.layers:
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
        return self

    def _infer_input_type(self) -> InputType:
        from deeplearning4j_tpu_torch.nn.conf.layers import LSTM

        first = self.conf.layers[0]
        n_in = getattr(first, "n_in", 0)
        if not n_in:
            raise ValueError(
                "Without setInputType, the first layer must declare n_in")
        if isinstance(first, LSTM):
            return InputType.recurrent(n_in)
        return InputType.feedForward(n_in)

    def _check_init(self):
        if self.params_list is None:
            raise RuntimeError("Call init() first")

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        """``a`` (numpy or tensor) on this network's device; float64 numpy
        arrays arrive as float32, as ``jnp.asarray`` gives them."""
        if not torch.is_tensor(a):
            a = np.asarray(a)
            if a.dtype == np.float64 and dtype is None:
                a = a.astype(np.float32)
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------------
    # forward and loss
    # ------------------------------------------------------------------
    def _forward(self, params_list, states_list, x, train: bool, generator,
                 fmask=None):
        """Forward through all layers: ``(out, new_states)``."""
        a = x
        if fmask is not None:
            a = a * fmask[..., None].to(a.dtype)
        new_states = []
        for i, layer in enumerate(self.conf.layers):
            a, ns = layer.apply(params_list[i], states_list[i], a, train,
                                generator)
            new_states.append(ns)
        return a, new_states

    def _loss_carries(self, params_list, states_list, carries, x, y, mask,
                      generator, fmask=None):
        """Training-mode forward to the loss head, threading recurrent
        carries when given (truncated BPTT). Returns ``(loss, (new_states,
        data_loss, new_carries))``; ``loss`` adds the l1/l2 terms."""
        conf = self.conf
        a = x
        if fmask is not None:
            a = a * fmask[..., None].to(a.dtype)
        new_states, new_carries = [], []
        for i, layer in enumerate(conf.layers[:-1]):
            if carries is not None and layer.is_recurrent:
                a, ns, c = layer.apply_with_carry(
                    params_list[i], states_list[i], carries[i], a, True,
                    generator)
            else:
                a, ns = layer.apply(params_list[i], states_list[i], a, True,
                                    generator)
                c = None
            new_states.append(ns)
            new_carries.append(c)
        new_carries.append(None)        # the loss head is never recurrent
        last = conf.layers[-1]
        if not hasattr(last, "loss_value"):
            raise ValueError("Last layer must be an OutputLayer to fit()")
        data_loss = last.loss_value(params_list[-1], states_list[-1], a, y,
                                    mask)
        new_states.append(states_list[-1])
        reg = torch.zeros((), dtype=data_loss.dtype, device=data_loss.device)
        for layer, p in zip(conf.layers, params_list):
            l1, l2 = layer.l1 or 0.0, layer.l2 or 0.0
            if l1 == 0.0 and l2 == 0.0:
                continue
            for k, v in p.items():
                if k in _REGULARIZED_KEYS:
                    if l1:
                        reg = reg + l1 * torch.sum(torch.abs(v))
                    if l2:
                        reg = reg + 0.5 * l2 * torch.sum(v * v)
        return data_loss + reg, (new_states, data_loss, new_carries)

    def _clip_grads(self, grads_list):
        mode = self.conf.gradient_normalization
        if not mode:
            return grads_list
        t = self.conf.gradient_normalization_threshold
        if mode == "ClipElementWiseAbsoluteValue":
            return [tree_map(lambda g: torch.clamp(g, -t, t), g)
                    for g in grads_list]
        if mode not in ("ClipL2PerLayer", "RenormalizeL2PerLayer"):
            raise ValueError(f"Unknown gradient normalization: {mode}")
        out = []
        for g in grads_list:
            # summed in the gradients' dtype, as the JAX step does
            sq = sum(torch.sum(leaf * leaf) for leaf in g.values())
            norm = torch.sqrt(torch.as_tensor(sq + 1e-12,
                                              device=self.device))
            if mode == "ClipL2PerLayer":
                scale = torch.clamp(t / norm, max=1.0)
                out.append(tree_map(lambda l, s=scale: l * s, g))
            else:
                out.append(tree_map(lambda l, n=norm: l / n, g))
        return out

    def _apply_updates(self, params_list, opt_states, grads, step):
        """One ``apply_updater`` per layer; ``p - u`` in the parameter's
        dtype."""
        new_params, new_opt = [], []
        for i, p in enumerate(params_list):
            updates, no = apply_updater(self._updaters[i], opt_states[i],
                                        grads[i], p, step)
            new_params.append({k: p[k] - updates[k] for k in p})
            new_opt.append(no)
        return new_params, new_opt

    def _train_step(self, x, y, mask, fmask, carries):
        """One update: forward, gradients of every parameter, clipping,
        updater. Returns ``(data_loss, new_carries)``, both detached."""
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in self.params_list]
        with torch.enable_grad():
            loss, (new_states, data_loss, new_carries) = self._loss_carries(
                leaves, self.states_list, carries, x, y, mask,
                self._generator, fmask)
            flat = [v for p in leaves for v in p.values()]
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(got)
        grads = [{k: (lambda g, v: torch.zeros_like(v) if g is None else g)(
            next(it), v) for k, v in p.items()} for p in leaves]
        grads = self._clip_grads(grads)
        with torch.no_grad():
            self.params_list, self.opt_states = self._apply_updates(
                self.params_list, self.opt_states, grads, self._iteration)
        self.states_list = new_states
        detached = [None if c is None else tuple(t.detach() for t in c)
                    for c in new_carries]
        return data_loss.detach(), detached

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def fit(self, data, labels=None, epochs: int = 1, fault_tolerance=None,
            auto_resume=None):
        """Train on arrays ``fit(x, y)`` or a ``DataSet``, ``epochs``
        passes over the one batch."""
        self._check_init()
        if fault_tolerance is not None or auto_resume is not None:
            raise _not_ported("fit(fault_tolerance=..., auto_resume=...)",
                              "A9")
        if isinstance(data, DataSet):
            for _ in range(epochs):
                self._fit_batch(data.features, data.labels, data.labels_mask,
                                data.features_mask)
            return self
        if not (torch.is_tensor(data) or isinstance(data, np.ndarray)):
            raise _not_ported(
                f"fit({type(data).__name__}) (DataSetIterator and other "
                f"sources)", "A9")
        if labels is None:
            raise ValueError("fit(x, y) requires labels")
        for _ in range(epochs):
            self._fit_batch(data, labels, None)
        return self

    def _features_mask(self, fm, x):
        if fm is None:
            return None
        fm = self._tensor(fm)
        if fm.dim() == 3 and fm.shape[-1] == 1:
            fm = fm[..., 0]
        if x.dim() != 3 or fm.dim() != 2 or fm.shape[1] != x.shape[1]:
            raise NotImplementedError(
                f"features mask shape {tuple(fm.shape)} not supported for "
                f"input of shape {tuple(x.shape)}: expected [N,T] (or "
                "[N,T,1]) matching a [N,T,F] sequence input")
        return fm

    def _fit_batch(self, x, y, mask, features_mask=None):
        x = self._tensor(x, self._dtype)
        y = self._tensor(y)
        fm = self._features_mask(features_mask, x)
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
        self._score, _ = self._train_step(x, y, m, fm, None)
        self._iteration += 1

    def _fit_tbptt(self, x, y, mask, k: int):
        """Truncated BPTT: segments of ``k`` timesteps, one update per
        segment, the recurrent state carried forward (detached, so no
        gradient crosses a segment) and reset at each minibatch; the
        iteration count (Adam's step) advances per segment."""
        if y.dim() < 3:
            raise ValueError("tBPTT requires per-timestep labels [N,T,C] "
                             "(use RnnOutputLayer)")
        n, t = x.shape[0], x.shape[1]
        carries = [(l.init_carry(n, self._dtype, self.device)
                    if l.is_recurrent else None) for l in self.conf.layers]
        for t0 in range(0, t, k):
            mc = mask[:, t0:t0 + k] if mask is not None else None
            self._score, carries = self._train_step(
                x[:, t0:t0 + k], y[:, t0:t0 + k], mc, None, carries)
            self._iteration += 1

    def pretrain(self, *args, **kwargs):
        raise _not_ported("layerwise pretraining", "A3")

    pretrainLayer = pretrain

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def output(self, x, train: bool = False, features_mask=None):
        """The network's output for ``x`` (a tensor on the device);
        ``train=True`` applies dropout."""
        self._check_init()
        xt = self._tensor(x, self._dtype)
        fm = self._features_mask(features_mask, xt)
        with torch.no_grad():
            out, _ = self._forward(self.params_list, self.states_list, xt,
                                   train, self._generator if train else None,
                                   fm)
        return out

    def rnnTimeStep(self, x):
        """One or more timesteps of stateful inference: the hidden state is
        kept across calls. 2-D input ``[N, F]`` is one step and returns
        ``[N, out]``; 3-D ``[N, T, F]`` steps T times and returns
        ``[N, T, out]``. A batch size other than the stored state's
        raises ``ValueError``."""
        self._check_init()
        xt = self._tensor(x, self._dtype)
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
                (l.init_carry(n, self._dtype, self.device)
                 if l.is_recurrent else None) for l in self.conf.layers]
            self._rnn_batch = n
        a = xt
        carries = []
        with torch.no_grad():
            for i, layer in enumerate(self.conf.layers):
                if layer.is_recurrent:
                    a, _, c = layer.apply_with_carry(
                        self.params_list[i], self.states_list[i],
                        self._rnn_carries[i], a, False, None)
                else:
                    a, _ = layer.apply(self.params_list[i],
                                       self.states_list[i], a, False, None)
                    c = None
                carries.append(c)
        self._rnn_carries = carries
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
        x = self._tensor(dataset.features, self._dtype)
        y = self._tensor(dataset.labels)
        m = (self._tensor(dataset.labels_mask)
             if dataset.labels_mask is not None else None)
        with torch.no_grad():
            loss, _ = self._loss_carries(self.params_list, self.states_list,
                                         None, x, y, m, None)
        return float(loss)

    def evaluate(self, *args, **kwargs):
        raise _not_ported("evaluation", "A9")

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
        return sum(int(t.numel()) for p in self.params_list
                   for t in p.values())

    def paramTable(self) -> dict:
        """``{"0_W": tensor, ...}``."""
        self._check_init()
        return {f"{i}_{k}": self.params_list[i][k]
                for i, k in self._flat_order()}

    # ------------------------------------------------------------------
    # not ported
    # ------------------------------------------------------------------
    def setListeners(self, *listeners):
        raise _not_ported("training listeners", "A9")

    addListeners = setListeners

    def setHealthMonitor(self, monitor):
        raise _not_ported("the model-health monitor", "A9")

    def getIterationCount(self) -> int:
        return self._iteration

    def getEpochCount(self) -> int:
        return self._epoch


__all__ = ["MultiLayerNetwork", "torch_dtype"]
