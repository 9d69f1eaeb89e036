"""Precision: the mixed-precision training policy and the serving-side
quantizers. Counterpart of ``deeplearning4j_tpu/nn/precision.py``,
copied rather than imported: the port never imports the JAX package.

The policy (``PrecisionPolicy``, :60-183 there) splits three dtypes:

- ``param_dtype``, the master weights: parameters and updater state stay
  f32 under the mixed presets, and ``p - u`` runs in f32 every step;
- ``compute_dtype``: each layer's parameters are cast to it once a step
  (:func:`cast_tree`, a ``.to()`` under autograd, whose backward hands
  the masters f32 gradients, as the JAX vjp of the cast does);
- ``output_dtype``: what ``output``, ``feedForward``, ``rnnTimeStep`` and
  ``backpropGradient`` hand back.

The f32 islands keep the loss heads (``fp32_loss_head``) and the
normalization layers (``fp32_layer_types``) in f32: their input is cast
up and the next reduced-precision layer casts it back down. Under
``mixed_float16`` the loss is scaled before the backward, the gradients
are unscaled in f32 and judged finite before any clipping, and a step
with a non-finite gradient is skipped: :func:`select` keeps the old
parameters, updater state and layer state with ``torch.where`` on the
device (no value is read back), while the scale halves; after
``growth_interval`` clean steps it doubles. The loss-scale state is four
device tensors (:func:`init_loss_scale`), so the step itself never syncs
with the host.

:func:`record_cast_count` and :func:`record_loss_scale` write the four
series of ``profiler.telemetry`` by site (``mln``, ``cg``): the scale
gauge, the overflow and skipped-step counters (one read-back a
mixed_float16 step, as in the JAX package; none with telemetry off) and
the cast-count gauge.

int8 (``DecodeEngine(quantization="int8")``): decode re-reads every
weight for one token per slot, so the decode step keeps its matmul
weights as int8 with one f32 scale per output channel and dequantizes
inside the matmul, ``(x @ q) * scale``. Symmetric scales bound each
channel's error by half an int8 step of that channel's max.

fp8 KV (``kv_dtype="fp8_e4m3"``): pages store ``torch.float8_e4m3fn``
with per-page-per-head f32 scales beside them, half the bytes of a
bf16 page. e4m3fn's largest finite value is 448 and an out-of-range
cast gives NaN (there is no inf), so :func:`quantize_fp8` clips to ±448
before the cast; the scale is floored so an all-zero page divides
cleanly. ``torch``'s f32 -> ``float8_e4m3fn`` cast rounds to nearest
even, as JAX's does, so quantized pages are bit-equal to the JAX
package's on equal inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.common.serde import serializable
from deeplearning4j_tpu_torch.ndarray.dtypes import DataType

#: the metric names of profiler/telemetry.py that this module writes
LOSS_SCALE = "dl4j_tpu_loss_scale"
LOSS_SCALE_OVERFLOWS = "dl4j_tpu_loss_scale_overflows_total"
LOSS_SCALE_SKIPPED_STEPS = "dl4j_tpu_loss_scale_skipped_steps_total"
PRECISION_CASTS = "dl4j_tpu_precision_casts_per_step"

#: layer/vertex class names whose compute stays f32 under the mixed
#: policies (normalization statistics must not accumulate in bf16/f16)
_FP32_NORM_LAYERS = ("BatchNormalization", "LocalResponseNormalization",
                     "LayerNormalization")


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a dtype name (the ``DataType`` values and their
    short aliases) or of a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return DataType.from_any(str(name)).torch


@serializable
@dataclasses.dataclass
class PrecisionPolicy:
    """The param/compute/output dtype triple, the f32 islands and the
    loss scaling, with the JAX class's fields and defaults (so the policy
    rides in ``configuration.json`` both ways).

    Use the presets, ``PrecisionPolicy.of("float32")``,
    ``of("mixed_bfloat16")`` and ``of("mixed_float16")``, or construct one.
    ``layer_overrides`` maps a layer index (``MultiLayerNetwork``) or a
    vertex or layer name (``ComputationGraph``) to a dtype string that
    replaces the compute dtype for that layer."""

    name: str = "float32"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"
    fp32_layer_types: tuple = _FP32_NORM_LAYERS
    fp32_loss_head: bool = True
    layer_overrides: dict = dataclasses.field(default_factory=dict)
    loss_scaling: bool = False
    initial_loss_scale: float = 2.0 ** 15
    loss_scale_growth: float = 2.0
    loss_scale_backoff: float = 0.5
    growth_interval: int = 200
    min_loss_scale: float = 1.0
    #: the growth ceiling: a scale doubled to f32 inf could never recover
    #: (inf * backoff = inf) and would skip every later step
    max_loss_scale: float = 2.0 ** 24

    def __post_init__(self):
        # JSON gives tuples back as lists and int keys as strings
        if isinstance(self.fp32_layer_types, list):
            self.fp32_layer_types = tuple(self.fp32_layer_types)
        if self.layer_overrides:
            self.layer_overrides = {
                (int(k) if str(k).lstrip("-").isdigit() else k): v
                for k, v in self.layer_overrides.items()}

    @staticmethod
    def of(name: str) -> "PrecisionPolicy":
        """A preset by name: "float32", "mixed_bfloat16" or
        "mixed_float16", with the dtype aliases of ``DataType.from_any``
        ("mixed_bf16", "mixed_fp16", ...)."""
        key = str(name).strip().lower()
        if key in ("float32", "f32", "fp32"):
            return PrecisionPolicy(name="float32")
        if key.startswith("mixed_"):
            dt = DataType.from_any(key[len("mixed_"):])
            if dt is DataType.BFLOAT16:
                return PrecisionPolicy(name="mixed_bfloat16",
                                       compute_dtype="bfloat16")
            if dt is DataType.HALF:
                return PrecisionPolicy(name="mixed_float16",
                                       compute_dtype="float16",
                                       loss_scaling=True)
        raise ValueError(
            f"Unknown precision policy {name!r} (expected 'float32', "
            "'mixed_bfloat16', 'mixed_float16', or a PrecisionPolicy)")

    @staticmethod
    def identity(dtype: str) -> "PrecisionPolicy":
        """The single-dtype policy of a configuration's ``dtype``: params,
        compute and output alike, no islands, no scaling."""
        return PrecisionPolicy(name=f"identity:{dtype}",
                               param_dtype=dtype, compute_dtype=dtype,
                               output_dtype=dtype, fp32_layer_types=(),
                               fp32_loss_head=False)

    @staticmethod
    def resolve(precision, conf_dtype: str) -> "PrecisionPolicy":
        """A configuration's policy: None (the single-dtype network of
        ``conf_dtype``), a preset name, or a ``PrecisionPolicy``."""
        if precision is None:
            return PrecisionPolicy.identity(conf_dtype)
        if isinstance(precision, PrecisionPolicy):
            return precision
        return PrecisionPolicy.of(precision)

    @property
    def is_identity(self) -> bool:
        """True when no cast or scaling is needed, so the networks keep
        their single-dtype paths. A uniform low-precision policy with f32
        islands configured is not the identity."""
        if (self.param_dtype != self.compute_dtype
                or self.compute_dtype != self.output_dtype
                or self.loss_scaling or self.layer_overrides):
            return False
        return (self.compute_dtype == "float32"
                or (not self.fp32_loss_head
                    and not self.fp32_layer_types))

    def layer_compute_dtype(self, layer, key) -> torch.dtype:
        """One layer's compute dtype. ``key`` is the layer index (MLN) or
        the vertex name (CG), looked up in ``layer_overrides`` first (and
        then ``layer.name``), then the f32 islands, then the policy's
        compute dtype."""
        ov = self.layer_overrides
        if ov:
            if key in ov:
                return torch_dtype(ov[key])
            lname = getattr(layer, "name", None)
            if lname is not None and lname in ov:
                return torch_dtype(ov[lname])
        if layer is not None:
            if self.fp32_loss_head and hasattr(layer, "loss_value"):
                return torch.float32
            if type(layer).__name__ in self.fp32_layer_types:
                return torch.float32
        return torch_dtype(self.compute_dtype)


# ---------------------------------------------------------------- casts
def _map(fn, *trees):
    """``fn`` over the paired leaves of trees of one structure, keeping
    dicts, lists and tuples as they are."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        out = [_map(fn, *xs) for xs in zip(*trees)]
        return tuple(out) if isinstance(t, tuple) else out
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _floating(a) -> bool:
    return torch.is_tensor(a) and a.is_floating_point()


def cast_leaf(a, dtype: torch.dtype):
    """One floating tensor in ``dtype``; other leaves (integer masks,
    counters) pass through."""
    if _floating(a) and a.dtype != dtype:
        return a.to(dtype)
    return a


def cast_tree(tree, dtype: torch.dtype):
    """Every floating leaf of a tree (one layer's parameters) in
    ``dtype``."""
    return _map(lambda a: cast_leaf(a, dtype), tree)


def count_casts(params_tree, dtype: torch.dtype) -> int:
    """The leaves that a step casts for compute dtype ``dtype``."""
    return sum(1 for a in _leaves(params_tree)
               if _floating(a) and a.dtype != dtype)


# ----------------------------------------------------- loss-scale state
def init_loss_scale(policy: PrecisionPolicy,
                    device=None) -> Optional[Dict[str, torch.Tensor]]:
    """A fresh loss-scale state on ``device`` (f32 ``scale``, int32
    ``good_steps``, ``overflows`` and ``skipped_steps``), or None when
    the policy does not scale. ``overflows`` equals ``skipped_steps``
    (every overflow skips one step); the two names are the telemetry's."""
    if not policy.loss_scaling:
        return None

    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return {"scale": torch.tensor(policy.initial_loss_scale,
                                  dtype=torch.float32, device=device),
            "good_steps": i32(), "overflows": i32(), "skipped_steps": i32()}


def scale_loss(loss: torch.Tensor, ls_state) -> torch.Tensor:
    return loss * ls_state["scale"].to(loss.dtype)


def unscale_grads(grads, ls_state):
    """The gradients divided by the live scale, in f32 (or wider): the
    master gradients."""
    inv = 1.0 / ls_state["scale"]

    def one(g):
        g = g.to(torch.promote_types(g.dtype, torch.float32))
        return g * inv.to(g.dtype)

    return _map(one, grads)


def all_finite(tree) -> torch.Tensor:
    """A 0-d bool tensor: every element of every floating leaf is
    finite (on the leaves' device; nothing is read back)."""
    flags = [torch.isfinite(l).all() for l in _leaves(tree) if _floating(l)]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all() if len(flags) > 1 else flags[0]


def select(pred: torch.Tensor, new_tree, old_tree):
    """Per leaf ``where(pred, new, old)``: the skip-step primitive (a leaf
    that the step left as it was, a frozen one, is kept without a
    copy)."""
    return _map(lambda n, o: torch.where(pred, n, o)
                if torch.is_tensor(n) and n is not o else n,
                new_tree, old_tree)


def update_loss_scale(policy: PrecisionPolicy, ls_state, finite):
    """The dynamic schedule: an overflow halves the scale (floored at
    ``min_loss_scale``) and resets the streak; ``growth_interval`` clean
    steps double it (capped at ``max_loss_scale``). The counters add on
    the device."""
    scale = ls_state["scale"]
    good = ls_state["good_steps"]
    grow = good + 1 >= policy.growth_interval
    grown = torch.where(grow, torch.clamp(scale * policy.loss_scale_growth,
                                          max=policy.max_loss_scale), scale)
    shrunk = torch.clamp(scale * policy.loss_scale_backoff,
                         min=policy.min_loss_scale)
    overflow = torch.logical_not(finite).to(torch.int32)
    zero = torch.zeros_like(good)
    return {
        "scale": torch.where(finite, grown, shrunk),
        "good_steps": torch.where(
            finite, torch.where(grow, zero, good + 1), zero).to(torch.int32),
        "overflows": ls_state["overflows"] + overflow,
        "skipped_steps": ls_state["skipped_steps"] + overflow,
    }


def scaled_value_and_grad(loss_fn, ls_state, params):
    """The loss-scaled forward and backward that every step shares:
    ``torch.autograd.grad`` of ``scale * loss_fn(params)`` into the leaves
    of ``params`` (tensors that require grad; a leaf the loss does not
    reach gets zeros, as ``jax.grad`` gives it), the gradients unscaled
    in f32, and their finiteness judged before any clipping (a clip would
    turn an inf into the threshold and hide the overflow). ``loss_fn``
    returns ``(loss, aux)``; returns ``((scaled loss, aux), unscaled
    gradients, finite)``."""
    with torch.enable_grad():
        loss, aux = loss_fn(params)
        scaled = scale_loss(loss, ls_state)
        flat = list(_leaves(params))
        got = torch.autograd.grad(scaled, flat, allow_unused=True)
    it = iter(torch.zeros_like(v) if g is None else g
              for g, v in zip(got, flat))
    grads = unscale_grads(_map(lambda _: next(it), params), ls_state)
    return (scaled, aux), grads, all_finite(grads)


def guard_scaled_step(policy: PrecisionPolicy, ls_state, finite,
                      new_old_pairs):
    """The skip-step tail every step shares: on a non-finite step each
    ``(new, old)`` tree pair resolves to old (parameters, updater state,
    layer state held), and the loss-scale state advances. Returns
    ``(guarded trees..., new loss-scale state)``."""
    guarded = tuple(select(finite, n, o) for n, o in new_old_pairs)
    return guarded + (update_loss_scale(policy, ls_state, finite),)


def record_cast_count(site: str, n: int) -> None:
    """The per-step cast-count gauge (``dl4j_tpu_precision_casts_per_step``
    by site), set when a network is initialised."""
    from deeplearning4j_tpu_torch.profiler import telemetry

    if not telemetry.enabled():
        return
    telemetry.MetricsRegistry.get_default().gauge(
        PRECISION_CASTS,
        "param leaves cast param_dtype->compute_dtype per compiled step"
    ).set(n, site=site)


def record_loss_scale(site: str, ls_state,
                      seen: Tuple[int, int]) -> Tuple[int, int]:
    """The loss-scale state into telemetry: the ``dl4j_tpu_loss_scale``
    gauge, and the overflow and skipped-step counters by their increase
    since ``seen``. One read-back of the three values (mixed_float16
    steps only); returns the new ``seen``. With telemetry off it reads
    nothing and returns ``seen``."""
    from deeplearning4j_tpu_torch.profiler import telemetry

    if not telemetry.enabled() or ls_state is None:
        return seen
    scale, of, sk = torch.stack([
        ls_state["scale"].to(torch.float64),
        ls_state["overflows"].to(torch.float64),
        ls_state["skipped_steps"].to(torch.float64)]).cpu().tolist()
    of, sk = int(of), int(sk)
    reg = telemetry.MetricsRegistry.get_default()
    reg.gauge(LOSS_SCALE, "current dynamic loss scale").set(
        scale, site=site)
    if of > seen[0]:
        reg.counter(LOSS_SCALE_OVERFLOWS,
                    "gradient overflows detected (non-finite grads)"
                    ).inc(of - seen[0], site=site)
    if sk > seen[1]:
        reg.counter(LOSS_SCALE_SKIPPED_STEPS,
                    "training steps skipped (params held) on overflow"
                    ).inc(sk - seen[1], site=site)
    return (of, sk)


def loss_scale_context(ls_state) -> str:
    """A loss-scale summary for error messages (reads the state back)."""
    if ls_state is None:
        return ""
    scale = float(ls_state["scale"])
    of, sk = int(ls_state["overflows"]), int(ls_state["skipped_steps"])
    return (f" [loss_scale={scale:g} overflows={of} "
            f"skipped_steps={sk}; a non-finite LOSS on an "
            "overflow step is expected — the step was skipped and the "
            "scale halved]")


# ------------------------------------------------------ int8 weights
def quantize_int8(w: torch.Tensor, axis: int = -1) -> Dict[str, Any]:
    """Symmetric per-channel int8 quantization of one weight tensor.

    ``axis`` is the kept (channel) axis: ``scale`` has shape
    ``(w.shape[axis],)`` and ``w ≈ q * scale`` broadcast along ``axis``.
    All-zero channels get scale 1 (q is then 0)."""
    axis = axis % w.dim()
    reduce_dims = tuple(i for i in range(w.dim()) if i != axis)
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=reduce_dims) if reduce_dims else wf.abs()
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    bshape = [1] * w.dim()
    bshape[axis] = -1
    q = torch.clamp(torch.round(wf / scale.reshape(bshape)), -127, 127) \
        .to(torch.int8)
    return {"q": q, "s": scale, "axis": axis}


def is_int8(leaf) -> bool:
    """True for a :func:`quantize_int8` result dict."""
    return (isinstance(leaf, dict) and "q" in leaf and "s" in leaf
            and getattr(leaf["q"], "dtype", None) == torch.int8)


def dequantize_int8(wq: Dict[str, Any],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The full-precision approximation ``q * scale``."""
    q, s = wq["q"], wq["s"]
    axis = int(wq.get("axis", -1)) % q.dim()
    bshape = [1] * q.dim()
    bshape[axis] = -1
    return q.to(dtype) * s.reshape(bshape).to(dtype)


def int8_matmul(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """``(x @ q) * scale`` for a weight quantized along its OUTPUT axis
    (``axis=1`` of an ``[in, out]`` matrix); a plain tensor passes
    through as ``x @ w``, so call sites need not know which they hold."""
    if is_int8(w):
        return (x @ w["q"].to(dtype)) * w["s"].to(dtype)
    return x @ w.to(dtype)


# ---------------------------------------------------------- fp8 KV
FP8_E4M3_MAX = 448.0
#: scale floor: keeps ``scale * 448 >= 1`` for pages whose absmax is
#: below 1, so tiny pages do not round-trip through denormal scales
FP8_SCALE_FLOOR = 1.0 / 448.0

_KV_DTYPE_ALIASES = {
    "fp8_e4m3": "fp8_e4m3", "fp8": "fp8_e4m3", "e4m3": "fp8_e4m3",
    "float8_e4m3fn": "fp8_e4m3", "float8_e4m3": "fp8_e4m3",
}


def resolve_kv_dtype(kv_dtype) -> Optional[str]:
    """Canonical KV-cache format: None / "" / "bf16" / "native" keep the
    compute dtype (None); "fp8", "e4m3", "float8_e4m3fn" and friends
    resolve to ``"fp8_e4m3"``. Raises on any other name."""
    if kv_dtype is None or kv_dtype == "":
        return None
    key = str(kv_dtype).strip().lower()
    if key in ("none", "bf16", "bfloat16", "native"):
        return None
    canon = _KV_DTYPE_ALIASES.get(key)
    if canon is None:
        raise ValueError(
            f"Unknown kv_dtype {kv_dtype!r} (expected None or one of "
            f"{sorted(set(_KV_DTYPE_ALIASES))})")
    return canon


def fp8_kv_dtype() -> torch.dtype:
    """The storage dtype behind ``kv_dtype="fp8_e4m3"``."""
    return torch.float8_e4m3fn


def fp8_scale(amax) -> torch.Tensor:
    """Per-page-per-head scale from an absmax: ``max(amax / 448,
    floor)`` in f32, shape-preserving."""
    a = torch.as_tensor(amax).to(torch.float32)
    return torch.clamp(a / FP8_E4M3_MAX, min=FP8_SCALE_FLOOR)


def quantize_fp8(x: torch.Tensor, scale) -> torch.Tensor:
    """``clip(x / scale, ±448)`` cast to ``float8_e4m3fn``; ``scale``
    broadcasts against ``x``."""
    xf = x.to(torch.float32) / torch.as_tensor(scale).to(torch.float32)
    return torch.clamp(xf, -FP8_E4M3_MAX, FP8_E4M3_MAX).to(fp8_kv_dtype())


def dequantize_fp8(q: torch.Tensor, scale,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in f32, cast to ``dtype``."""
    return (q.to(torch.float32)
            * torch.as_tensor(scale).to(torch.float32)).to(dtype)


__all__ = ["PrecisionPolicy", "torch_dtype", "cast_leaf", "cast_tree",
           "count_casts", "init_loss_scale", "scale_loss", "unscale_grads",
           "all_finite", "select", "update_loss_scale",
           "scaled_value_and_grad", "guard_scaled_step",
           "record_cast_count", "record_loss_scale", "loss_scale_context",
           "LOSS_SCALE", "LOSS_SCALE_OVERFLOWS", "LOSS_SCALE_SKIPPED_STEPS",
           "PRECISION_CASTS",
           "quantize_int8", "is_int8", "dequantize_int8", "int8_matmul",
           "FP8_E4M3_MAX", "FP8_SCALE_FLOOR", "resolve_kv_dtype",
           "fp8_kv_dtype", "fp8_scale", "quantize_fp8", "dequantize_fp8"]
