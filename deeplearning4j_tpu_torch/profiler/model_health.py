"""In-step model health: counterpart of
``deeplearning4j_tpu/profiler/model_health.py``.

Per-layer statistics of each training step, computed on the card from
what the step already holds (no second backward pass):

- gradient L2 norms (the raw master-precision gradients, before
  clipping), parameter L2 norms after the update, and update-to-parameter
  ratios, each summed in f32 per layer;
- non-finite provenance: a per-layer flag for "this layer's training
  forward output, or its gradient, holds a NaN or an Inf" and the first
  such layer, forward flags first (a poisoned input reads layer 0, a layer
  k that blows up reads k). An overflow that ``mixed_float16``'s loss
  scaling handled (step skipped, scale halved) reads as clean (-1), with
  the raw index kept as ``last["handled_overflow_layer"]``;
- MFU: the step's FLOPs over the wall clock between two samples over the
  card's peak for the compute dtype (``profiler.flops``).

The JAX step computes the statistics in XLA; here they are batched
library reductions on the card, a few launches each whatever the number
of layers (a ResNet-50 step's host is what they cost): ``torch._foreach_norm``
(in f32) over the gradients, the parameters and the update deltas (both
sides flattened by one ``cat`` each and subtracted once), one
``index_add_`` per statistic into per-layer sums, and for the flags one
inf-norm reduction per layer's output, turned into flags together.
The statistics stay on the card as a small dict; every ``frequency``
steps the monitor packs it into one tensor and reads it back (one
transfer, ``fetches``). An unsampled step reads nothing back.

The step's FLOPs: the JAX package takes XLA's cost analysis of the
compiled step. The port has no compiled step, and
``torch.utils.flop_counter.FlopCounterMode`` cannot see the hand kernels
(they launch through ``ctypes``). So the count of a step is
FlopCounterMode over the library operations of one step, plus the
analytic matrix-product count that each kernel wrapper adds at its launch
(``ops.native.kernel_flops``). It is taken once per input signature (the
first monitored step of each) and charged to every later step of that
signature.

With no monitor attached, the networks' steps run exactly as before: no
flag, no reduction, no read-back.
"""

from __future__ import annotations

import contextlib
import logging
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence

import torch

log = logging.getLogger("deeplearning4j_tpu_torch")

#: latest measured FLOPs of one step per site (``mln_step``,
#: ``mln_tbptt_step``, ``cg_step``)
_site_flops: Dict[str, float] = {}
#: FLOPs dispatched per site: each monitored step adds its signature's
#: count, and an MFU sample reads the delta over its window
_site_dispatched: Dict[str, float] = {}
#: index tensors of the per-layer sums, by device and leaf-to-layer map
_segments: Dict[Any, torch.Tensor] = {}


# ======================================================================
# on-card reductions (called inside the training step)
# ======================================================================
def _float_leaves(tree) -> List[torch.Tensor]:
    from deeplearning4j_tpu_torch.params import tree_leaves

    return [l for l in tree_leaves(tree)
            if torch.is_tensor(l) and l.is_floating_point()]


def _segment_index(seg: Sequence[int], device) -> torch.Tensor:
    key = (str(device), tuple(seg))
    idx = _segments.get(key)
    if idx is None:
        if len(_segments) > 64:
            _segments.clear()
        idx = _segments[key] = torch.tensor(seg, dtype=torch.long,
                                            device=device)
    return idx


def _layer_sq(per_layer: List[List[torch.Tensor]], device) -> torch.Tensor:
    """``[L]`` f32 sums of squares, one per layer's list of leaves: one
    ``_foreach_norm`` (in f32, whatever the leaves' dtype) over every leaf,
    then one ``index_add_``. A NaN or an Inf in a layer makes its sum
    non-finite."""
    leaves, seg = [], []
    for i, ls in enumerate(per_layer):
        leaves.extend(ls)
        seg.extend([i] * len(ls))
    out = torch.zeros(len(per_layer), dtype=torch.float32, device=device)
    if leaves:
        norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
        sq = torch.stack(norms).square()
        out.index_add_(0, _segment_index(seg, device), sq)
    return out


def _deltas(new: List[List[torch.Tensor]], old: List[List[torch.Tensor]]):
    """Per layer, the views of ``new - old`` in f32: every leaf flattened
    into one vector per side (one ``cat`` each), one subtraction, split
    back; a handful of launches whatever the number of leaves."""
    sizes = [l.numel() for ls in new for l in ls]
    if not sizes:
        return [[] for _ in new]
    flat = lambda side: torch.cat([l.reshape(-1) for ls in side
                                   for l in ls]).to(torch.float32)
    parts = iter(torch.split(flat(new) - flat(old), sizes))
    return [[next(parts) for _ in ls] for ls in new]


def act_flag(a) -> torch.Tensor:
    """Per-layer forward provenance probe: the largest magnitude in this
    activation (or loss value) as a 0-d f32 tensor on its device, one
    reduction, non-finite exactly when ``a`` holds a NaN or an Inf.
    :func:`device_stats` turns the layers' probes into flags at once."""
    if not (torch.is_tensor(a) and a.is_floating_point()):
        dev = a.device if torch.is_tensor(a) else None
        return torch.zeros((), dtype=torch.float32, device=dev)
    return torch.linalg.vector_norm(a, float("inf"), dtype=torch.float32)


def device_stats(keys: Sequence, grads, new_params, old_params,
                 act_bad: Optional[List], handled=None,
                 device=None) -> Dict[str, torch.Tensor]:
    """One step's health as a small dict of tensors on the card.

    ``keys`` fixes the layer order (list indices of a MultiLayerNetwork,
    ``conf.nodes`` order of a ComputationGraph); ``grads`` are the raw
    (before clipping, master-precision) gradients, empty for a frozen
    layer; ``new_params`` / ``old_params`` the parameters after and before
    the update (after the loss-scale guard, so a skipped step reads an
    update ratio of 0); ``act_bad`` the per-layer forward probes of
    :func:`act_flag` (or None); ``handled`` a bool tensor marking an
    overflow that loss scaling handled."""
    if device is None:
        first = next((l for k in keys for l in _float_leaves(new_params[k])),
                     None)
        device = first.device if first is not None else torch.device("cpu")
    gsq = _layer_sq([_float_leaves(grads[k] if isinstance(grads, list)
                                   else grads.get(k, {})) for k in keys],
                    device)
    new = [_float_leaves(new_params[k]) for k in keys]
    old = [_float_leaves(old_params[k]) for k in keys]
    psq = _layer_sq(new, device)
    usq = _layer_sq(_deltas(new, old), device)
    gn, pn = gsq.sqrt(), psq.sqrt()
    ur = usq.sqrt() / (pn + 1e-12)
    g_bad = torch.logical_not(torch.isfinite(gsq))
    if act_bad:
        act_vec = torch.logical_not(torch.isfinite(torch.stack(
            [a.to(device) for a in act_bad])))
    else:
        act_vec = torch.zeros(len(keys), dtype=torch.bool, device=device)
    bad_vec = torch.logical_or(act_vec, g_bad)
    # first offender: the forward flags take priority, the gradient flags
    # break the tie when the forward was clean
    a_i, b_i = act_vec.to(torch.int32), bad_vec.to(torch.int32)
    minus1 = torch.full((), -1, dtype=torch.int64, device=device)
    first = torch.where(a_i.any(), a_i.argmax(),
                        torch.where(b_i.any(), b_i.argmax(), minus1))
    if handled is None:
        handled = torch.zeros((), dtype=torch.bool, device=device)
    return {"grad_norm": gn, "param_norm": pn, "update_ratio": ur,
            "nonfinite": bad_vec, "first_nonfinite": first.to(torch.int32),
            "handled": handled.reshape(())}


def _pack(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The health dict as one f32 vector: grad norms, parameter norms,
    update ratios, flags ([L] each), then the first index and the
    handled bit (one read-back)."""
    f32 = torch.float32
    return torch.cat([tree["grad_norm"].to(f32), tree["param_norm"].to(f32),
                      tree["update_ratio"].to(f32), tree["nonfinite"].to(f32),
                      tree["first_nonfinite"].to(f32).reshape(1),
                      tree["handled"].to(f32).reshape(1)])


# ======================================================================
# model seam helpers
# ======================================================================
def split_health(res, monitored: bool):
    """``(core, health)`` of a step's outputs: the monitored step appends
    its health dict last; an unmonitored step's outputs pass through with
    None."""
    if monitored:
        return res[:-1], res[-1]
    return res, None


def layer_keys(model) -> List:
    """Container keys in layer order: list indices of a
    MultiLayerNetwork, ``conf.nodes`` names of a ComputationGraph."""
    if hasattr(model, "params_map"):
        return [n.name for n in model.conf.nodes]
    return list(range(len(model.conf.layers)))


def layer_names(model) -> List[str]:
    """Readable layer labels, aligned with :func:`layer_keys`."""
    if hasattr(model, "params_map"):
        return [n.name for n in model.conf.nodes]
    return [f"{i}:{type(l).__name__}"
            for i, l in enumerate(model.conf.layers)]


# ======================================================================
# the step's FLOPs
# ======================================================================
@contextlib.contextmanager
def counting_flops():
    """Count the FLOPs of the code in the block: ``box["flops"]`` after
    it is ``torch.utils.flop_counter.FlopCounterMode``'s total over the
    library operations plus the hand kernels' analytic counts
    (``ops.native.kernel_flops``) of the launches in the block."""
    from torch.utils.flop_counter import FlopCounterMode

    from deeplearning4j_tpu_torch.ops import native

    box: Dict[str, float] = {}
    k0 = native.kernel_flops
    with FlopCounterMode(display=False) as fc:
        yield box
    box["library"] = float(fc.get_total_flops())
    box["kernels"] = float(native.kernel_flops - k0)
    box["flops"] = box["library"] + box["kernels"]


def set_site_flops(site: str, flops: float) -> None:
    """Record a measured step's FLOPs for ``site`` (and its gauge)."""
    from deeplearning4j_tpu_torch.profiler import telemetry

    _site_flops[site] = flops
    if telemetry.enabled():
        telemetry.MetricsRegistry.get_default().gauge(
            telemetry.STEP_FLOPS,
            "FLOPs of one training step: library operations counted by "
            "torch.utils.flop_counter plus the hand kernels' analytic "
            "matrix-product counts").set(flops, site=site)


def add_dispatched_flops(site: str, flops: float) -> None:
    _site_dispatched[site] = _site_dispatched.get(site, 0.0) + flops


def dispatched_flops(site: str) -> float:
    return _site_dispatched.get(site, 0.0)


def site_flops(site: str) -> Optional[float]:
    return _site_flops.get(site)


def step_signature(*tensors) -> tuple:
    """The shapes and dtypes of a step's inputs (None for an absent
    one): the key its FLOP count is kept under."""
    return tuple(None if t is None else (tuple(t.shape), str(t.dtype))
                 for t in tensors)


# ======================================================================
# the monitor
# ======================================================================
class HealthMonitor:
    """In-step model-health policy. Attach with
    ``net.setHealthMonitor(HealthMonitor(frequency=N))``, detach with
    ``setHealthMonitor(None)``.

    Each step of a monitored network computes the health dict on the
    card; every ``frequency`` steps the monitor reads it back (one
    transfer), publishes the per-layer gauges and ``dl4j_tpu_mfu``, and
    refreshes ``last``, the host-side dict the divergence guard and the
    listeners read."""

    def __init__(self, frequency: int = 10, mfu: bool = True):
        self.frequency = max(int(frequency), 1)
        self.mfu = bool(mfu)
        #: latest host-side sample (None until the first fetch)
        self.last: Optional[Dict[str, Any]] = None
        self._device = None          # latest on-card health dict
        self._names: Optional[List[str]] = None
        self._model_ref = None
        self._site = "?"
        self._jit_site: Optional[str] = None
        self._compute_dtype = "float32"
        self._model_device = None
        self._iteration = 0
        self._steps = 0
        self._fetches = 0
        self._last_t: Optional[float] = None
        self._last_steps = 0
        self._last_disp = 0.0
        self._last_disp_site = None
        #: measured FLOPs per (site, input signature)
        self._sig_flops: Dict[Any, float] = {}

    # ---------------------------------------------------------- FLOPs
    def wants_flops(self, site: str, sig) -> bool:
        """Whether the step of ``site`` with inputs ``sig`` should run
        under :func:`counting_flops` (its first monitored step, MFU on)."""
        return self.mfu and (site, sig) not in self._sig_flops

    def record_flops(self, site: str, sig, flops: float) -> None:
        self._sig_flops[(site, sig)] = flops
        set_site_flops(site, flops)

    def charge_flops(self, site: str, sig) -> None:
        f = self._sig_flops.get((site, sig)) or _site_flops.get(site)
        if f:
            add_dispatched_flops(site, f)

    # ------------------------------------------------------------ wiring
    def on_step(self, model, health_tree, site: str,
                jit_site: Optional[str] = None) -> None:
        """Fit-loop hook: keep this step's on-card health dict; read it
        back and publish every ``frequency`` steps, never otherwise."""
        self._device = health_tree
        self._site = site
        self._jit_site = jit_site
        if self._model_ref is None or self._model_ref() is not model:
            self._model_ref = weakref.ref(model)
            self._names = layer_names(model)
        policy = getattr(model, "_policy", None)
        if policy is not None:
            self._compute_dtype = policy.compute_dtype
        self._model_device = getattr(model, "device", None)
        self._iteration = int(getattr(model, "_iteration", 0))
        self._steps += 1
        if self._steps % self.frequency == 0:
            self.sample()

    # ---------------------------------------------------------- sampling
    def sample(self) -> Optional[Dict[str, Any]]:
        """Read the latest health dict back (one transfer), publish the
        gauges, refresh ``last``; returns the sample."""
        if self._device is None:
            return None
        from deeplearning4j_tpu_torch.profiler import telemetry

        host = _pack(self._device).cpu().tolist()
        self._fetches += 1
        now = time.perf_counter()
        names = self._names or []
        n = len(names)
        gns, pns, urs = host[:n], host[n:2 * n], host[2 * n:3 * n]
        bad = host[3 * n:4 * n]
        first, handled = int(host[4 * n]), bool(host[4 * n + 1])
        report = -1 if handled else first
        sample: Dict[str, Any] = {
            "iteration": self._iteration,
            "grad_norms": {}, "param_norms": {}, "update_ratios": {},
            "nonfinite_layers": [],
            "nonfinite_first_layer": report,
            "nonfinite_layer_name": (names[report]
                                     if 0 <= report < n else None),
            "handled_overflow": handled,
            "handled_overflow_layer": first if handled else -1,
        }
        reg = telemetry.MetricsRegistry.get_default() \
            if telemetry.enabled() else None
        if reg is not None:
            reg.counter(
                telemetry.HEALTH_FETCHES,
                "model-health device->host fetches (one per sampled "
                "step)").inc(site=self._site)
        gn = reg.gauge(telemetry.LAYER_GRAD_NORM,
                       "per-layer gradient L2 norm (raw master-"
                       "precision grads, pre-clip)") if reg else None
        pn = reg.gauge(telemetry.LAYER_PARAM_NORM,
                       "per-layer parameter L2 norm (post-update)") \
            if reg else None
        ur = reg.gauge(telemetry.UPDATE_RATIO,
                       "per-layer update-to-param L2 ratio") if reg else None
        for i, nm in enumerate(names):
            sample["grad_norms"][nm] = gns[i]
            sample["param_norms"][nm] = pns[i]
            sample["update_ratios"][nm] = urs[i]
            if bad[i] and not handled:
                sample["nonfinite_layers"].append(nm)
            if reg is not None:
                gn.set(gns[i], layer=nm, site=self._site)
                pn.set(pns[i], layer=nm, site=self._site)
                ur.set(urs[i], layer=nm, site=self._site)
        if reg is not None:
            reg.gauge(telemetry.NONFINITE_FIRST_LAYER,
                      "index of the first layer whose activation/"
                      "gradient went NaN/Inf (-1 = clean; loss-scale-"
                      "handled overflows report clean)"
                      ).set(report, site=self._site)
        mfu = self._compute_mfu(now)
        if mfu is not None:
            sample["mfu"] = mfu
            if reg is not None:
                reg.gauge(telemetry.MFU,
                          "model FLOPs utilization of the live step "
                          "(counted FLOPs / wall clock / dtype-aware "
                          "peak)").set(mfu, site=self._site)
        self._last_t = now
        self._last_steps = self._steps
        self._last_disp_site = self._jit_site
        self._last_disp = _site_dispatched.get(self._jit_site or "", 0.0)
        self.last = sample
        return sample

    def _compute_mfu(self, now: float) -> Optional[float]:
        """FLOPs dispatched at the step's site since the last sample over
        the wall clock since then over the peak of the compute dtype. The
        read-back that preceded this call waited for the card, so the
        window covers the card's work, not only its dispatch."""
        if not self.mfu or self._last_t is None:
            return None
        site = self._jit_site or ""
        if self._last_disp_site != self._jit_site:
            return None       # the anchor belongs to another site
        num = _site_dispatched.get(site, 0.0) - self._last_disp
        if num <= 0:
            flops = _site_flops.get(site)
            steps = self._steps - self._last_steps
            if not flops or steps <= 0:
                return None
            num = flops * steps
        elapsed = now - self._last_t
        if elapsed <= 0:
            return None
        from deeplearning4j_tpu_torch.profiler.flops import peak_flops

        peak = peak_flops(self._compute_dtype, self._model_device)
        if not peak:
            return None       # unknown device: peak_flops warned already
        return num / (elapsed * peak)

    def latest(self) -> Optional[Dict[str, Any]]:
        """The sample of the most recent step: ``last`` when it is that
        step's, else a fresh read-back."""
        if self.last is not None \
                and self.last["iteration"] == self._iteration:
            return self.last
        return self.sample()

    # ------------------------------------------------------- provenance
    def nonfinite_label(self) -> Optional[str]:
        """Name of the first non-finite layer of the most recent step (a
        read-back of two scalars), or None when clean, handled or nothing
        was recorded. The divergence guard labels its rollback with it."""
        if self._device is None:
            return None
        both = torch.stack([self._device["first_nonfinite"].to(torch.int32),
                            self._device["handled"].to(torch.int32)])
        first, handled = both.cpu().tolist()
        if handled or first < 0:
            return None
        names = self._names or []
        return names[first] if first < len(names) else str(first)

    @property
    def fetches(self) -> int:
        """Read-backs of the health dict so far (one per sampled step)."""
        return self._fetches


__all__ = ["HealthMonitor", "device_stats", "act_flag", "split_health",
           "layer_keys", "layer_names", "counting_flops", "set_site_flops",
           "add_dispatched_flops", "dispatched_flops", "site_flops",
           "step_signature"]
