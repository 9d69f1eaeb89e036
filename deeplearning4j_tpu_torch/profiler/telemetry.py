"""Telemetry: counterpart of ``deeplearning4j_tpu/profiler/telemetry.py``.

The process-wide sink that every layer of the port reports through:

- ``MetricsRegistry``: thread-safe counters, gauges and bounded
  histograms, rendered as Prometheus text (``to_prometheus``) and JSON
  (``to_json``) in the JAX package's format, character for character.
- ``span()``: nestable host-side timing; the events land in a bounded
  buffer and export as Chrome trace-event JSON (``export_chrome_trace``;
  perfetto, chrome://tracing), the host's side beside ``torch.profiler``'s
  device trace.
- ``record_phase``: the fit loops' step phases (``etl_wait``,
  ``device_step``, ``listener_host``) as spans and as samples of
  ``dl4j_tpu_step_phase_seconds``.
- ``sample_device_memory()``: the card's allocator watermarks
  (``torch.cuda.memory_stats``) into gauges;
  on the CPU it returns ``{}``.

Everything here is host-side: a disabled check is one attribute read, an
enabled step records a few ``perf_counter`` deltas and deque appends,
never a read-back from the card.

Not here: the JAX module's recompile detector (``instrument_jit``), since
the port compiles no program per input signature (its counterpart is the
CUDA-graph capture of ROADMAP A7.9), and the serving engines' snapshot
and series expiry (``serving_snapshot``, ``retire_engine_series``, A7.7).

Env: ``DL4J_TPU_TELEMETRY=0`` disables recording (default on).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger("deeplearning4j_tpu_torch")

_ENABLED = os.environ.get("DL4J_TPU_TELEMETRY", "1") != "0"
_T0 = time.perf_counter()   # trace-timestamp epoch (µs since import)

#: canonical metric names (acceptance surface — keep stable)
JIT_COMPILES = "dl4j_tpu_jit_compiles_total"
JIT_COMPILE_SECONDS = "dl4j_tpu_jit_compile_seconds"
STEP_PHASE_SECONDS = "dl4j_tpu_step_phase_seconds"
DEVICE_BYTES_IN_USE = "dl4j_tpu_device_bytes_in_use"
DEVICE_PEAK_BYTES = "dl4j_tpu_device_peak_bytes_in_use"
#: device input pipeline (datasets/device_prefetch.py)
PREFETCH_QUEUE_DEPTH = "dl4j_tpu_prefetch_queue_depth"
TRANSFER_OVERLAP_MS = "dl4j_tpu_prefetch_transfer_overlap_ms"
PREFETCH_PADDED_EXAMPLES = "dl4j_tpu_prefetch_padded_examples_total"
BUCKET_HITS = "dl4j_tpu_shape_bucket_hits_total"
BUCKET_MISSES = "dl4j_tpu_shape_bucket_misses_total"
ON_DEVICE_BATCHES = "dl4j_tpu_on_device_batches_total"
#: mixed-precision engine (nn/precision.py)
LOSS_SCALE = "dl4j_tpu_loss_scale"
LOSS_SCALE_OVERFLOWS = "dl4j_tpu_loss_scale_overflows_total"
LOSS_SCALE_SKIPPED_STEPS = "dl4j_tpu_loss_scale_skipped_steps_total"
PRECISION_CASTS = "dl4j_tpu_precision_casts_per_step"
#: fault tolerance (util/resilience.py, profiler/chaos.py)
FT_ROLLBACKS = "dl4j_tpu_ft_rollbacks_total"
FT_SKIPPED_BATCHES = "dl4j_tpu_ft_skipped_batches_total"
FT_PREEMPTION_CHECKPOINTS = "dl4j_tpu_ft_preemption_checkpoints_total"
FT_PERIODIC_CHECKPOINTS = "dl4j_tpu_ft_periodic_checkpoints_total"
FT_AUTO_RESUMES = "dl4j_tpu_ft_auto_resumes_total"
TRANSFER_RETRIES = "dl4j_tpu_transfer_retries_total"
TRANSFER_QUARANTINES = "dl4j_tpu_transfer_quarantined_batches_total"
WATCHDOG_STALLS = "dl4j_tpu_watchdog_stalls_total"
CHAOS_INJECTED = "dl4j_tpu_chaos_injected_total"
#: cross-replica update sharding (parallel/zero.py)
MASTER_PARAM_BYTES = "dl4j_tpu_master_param_bytes"
OPT_STATE_BYTES = "dl4j_tpu_opt_state_bytes"
#: in-step model health (profiler/model_health.py)
LAYER_GRAD_NORM = "dl4j_tpu_layer_grad_norm"
LAYER_PARAM_NORM = "dl4j_tpu_layer_param_norm"
UPDATE_RATIO = "dl4j_tpu_update_ratio"
NONFINITE_FIRST_LAYER = "dl4j_tpu_nonfinite_first_layer"
MFU = "dl4j_tpu_mfu"
STEP_FLOPS = "dl4j_tpu_step_flops"
HEALTH_FETCHES = "dl4j_tpu_health_fetches_total"
#: continuous-batching decode engine (serving/engine.py)
SERVING_REQUESTS = "dl4j_tpu_serving_requests_total"
SERVING_TOKENS = "dl4j_tpu_serving_tokens_total"
SERVING_REQUEST_LATENCY = "dl4j_tpu_serving_request_latency_seconds"
SERVING_TTFT = "dl4j_tpu_serving_ttft_seconds"
SERVING_QUEUE_DEPTH = "dl4j_tpu_serving_queue_depth"
SERVING_SLOT_OCCUPANCY = "dl4j_tpu_serving_slot_occupancy"
SERVING_KV_PAGE_UTILIZATION = "dl4j_tpu_serving_kv_page_utilization"
SERVING_KV_PAGE_BYTES = "dl4j_tpu_serving_kv_page_bytes"
SERVING_WARM_HITS = "dl4j_tpu_serving_warm_pool_hits_total"
SERVING_WARM_MISSES = "dl4j_tpu_serving_warm_pool_misses_total"
SERVING_DECODE_STEPS = "dl4j_tpu_serving_decode_steps_total"
SERVING_DECODE_STEP_SECONDS = "dl4j_tpu_serving_decode_step_seconds"
SERVING_PREFILL_SECONDS = "dl4j_tpu_serving_prefill_seconds"
#: speculative decoding (serving/spec_decode.py): drafts proposed /
#: accepted, the cumulative acceptance-rate + tokens-per-weight-read
#: gauges, and the verify-dispatch latency histogram
SERVING_SPEC_PROPOSED = "dl4j_tpu_serving_spec_proposed_tokens_total"
SERVING_SPEC_ACCEPTED = "dl4j_tpu_serving_spec_accepted_tokens_total"
SERVING_SPEC_ACCEPTANCE = "dl4j_tpu_serving_spec_acceptance_rate"
SERVING_TOKENS_PER_DISPATCH = "dl4j_tpu_serving_tokens_per_dispatch"
SERVING_VERIFY_SECONDS = "dl4j_tpu_serving_verify_seconds"
#: cross-request KV reuse (serving/prefix_cache.py, sessions.py)
SERVING_PREFIX_HITS = "dl4j_tpu_serving_prefix_cache_hits_total"
SERVING_PREFIX_MISSES = "dl4j_tpu_serving_prefix_cache_misses_total"
SERVING_PREFIX_HIT_TOKENS = \
    "dl4j_tpu_serving_prefix_cache_hit_tokens_total"
SERVING_PREFIX_EVICTED_PAGES = \
    "dl4j_tpu_serving_prefix_cache_evicted_pages_total"
SERVING_PREFIX_CACHED_PAGES = "dl4j_tpu_serving_prefix_cached_pages"
SERVING_SHARED_PAGES = "dl4j_tpu_serving_shared_kv_pages"
SERVING_PINNED_PAGES = "dl4j_tpu_serving_session_pinned_pages"
SERVING_SESSION_EVICTIONS = \
    "dl4j_tpu_serving_session_evictions_total"
SERVING_WARM_TTFT = "dl4j_tpu_serving_warm_ttft_seconds"
#: serving fleet (serving/fleet.py) — every SERVING_* series above is
#: also labelled ``engine=<id>`` so N engines in one process stay
#: distinguishable; these are the fleet-level series
SERVING_REJECTS = "dl4j_tpu_serving_capacity_rejects_total"
SERVING_FLEET_ROUTED = "dl4j_tpu_serving_fleet_routed_total"
SERVING_FLEET_REROUTES = "dl4j_tpu_serving_fleet_reroutes_total"
SERVING_FLEET_REPLICAS = "dl4j_tpu_serving_fleet_live_replicas"
SERVING_LANE_PREFILLS = "dl4j_tpu_serving_prefill_lane_prefills_total"
SERVING_LANE_SECONDS = "dl4j_tpu_serving_prefill_lane_seconds"
SERVING_HANDOFF_SECONDS = "dl4j_tpu_serving_handoff_seconds"
SERVING_FLEET_PRESSURE = "dl4j_tpu_serving_fleet_queue_pressure"
SERVING_FLEET_SIZE = "dl4j_tpu_serving_fleet_size"
SERVING_FLEET_PENDING_SCALE = "dl4j_tpu_serving_fleet_pending_scale"
#: queued dynamic-batching inference (parallel/wrapper.py)
INFERENCE_REQUEST_LATENCY = "dl4j_tpu_inference_request_latency_seconds"
INFERENCE_QUEUE_DEPTH = "dl4j_tpu_inference_queue_depth"
INFERENCE_BATCH_OCCUPANCY = "dl4j_tpu_inference_batch_occupancy"
#: tracing + flight recorder (profiler/tracing.py, flight_recorder.py)
SPANS_DROPPED = "dl4j_tpu_spans_dropped_total"
INCIDENT_DUMPS = "dl4j_tpu_incident_dumps_total"
#: elastic control plane (control/scheduler.py) — one JobScheduler
#: owning a device fleet and running many train/serve jobs over it
JOBS_SUBMITTED = "dl4j_tpu_jobs_submitted_total"
JOBS_FINISHED = "dl4j_tpu_jobs_finished_total"
JOBS_RESTARTS = "dl4j_tpu_jobs_restarts_total"
JOBS_MIGRATIONS = "dl4j_tpu_jobs_migrations_total"
JOBS_RUNNING = "dl4j_tpu_jobs_running"
JOBS_DEVICES = "dl4j_tpu_jobs_devices"
JOBS_THROUGHPUT = "dl4j_tpu_job_throughput"
JOBS_MFU = "dl4j_tpu_job_mfu"
JOBS_LATENCY_P50 = "dl4j_tpu_job_request_p50_ms"
#: control plane phase 2 (control/worker.py, preemption notices)
JOBS_PREEMPTIONS = "dl4j_tpu_jobs_preemptions_total"
#: control plane phase 3 (alert-driven fleet elasticity)
FLEET_SCALE_UP = "dl4j_tpu_fleet_scale_up_total"
FLEET_SCALE_DOWN = "dl4j_tpu_fleet_scale_down_total"
WORKER_PROCESSES = "dl4j_tpu_worker_processes"
WORKER_HEARTBEAT_AGE = "dl4j_tpu_worker_heartbeat_age_seconds"
FT_BUNDLE_IO_RETRIES = "dl4j_tpu_ft_bundle_io_retries_total"
#: SLO / alerting engine (profiler/slo.py)
ALERTS_TOTAL = "dl4j_tpu_alerts_total"
ALERTS_ACTIVE = "dl4j_tpu_alerts_active"
#: managed device-profile captures (profiler/programs.py)
PROFILE_CAPTURES = "dl4j_tpu_profile_captures_total"


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


# ---------------------------------------------------------------- utils
def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    esc = lambda v: v.replace("\\", "\\\\").replace('"', '\\"') \
                     .replace("\n", "\\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in key) + "}"


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


def _fmt_value(v: float) -> str:
    """Prometheus sample-value rendering: the exposition format spells
    non-finite values ``NaN`` / ``+Inf`` / ``-Inf`` (python's ``%g``
    gives ``nan`` / ``inf``, which real scrapers reject)."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return f"{v:g}"


def _escape_help(text: str) -> str:
    """# HELP escaping per the exposition format: backslash and
    newline only (quotes are NOT escaped in help text)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


# -------------------------------------------------------------- metrics
class Counter:
    """Monotonic counter, optionally labelled (one value per label set)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values: Dict[Tuple, float] = collections.defaultdict(float)

    def inc(self, n: float = 1.0, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] += n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._values.values())

    def values(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Copy of every label set's value, insertion-ordered."""
        with self._lock:
            return dict(self._values)

    def remove_matching(self, label: str, value: str) -> int:
        """Drop every label set where ``label == value`` (stale-series
        expiry: a shut-down engine's gauges must not stay frozen at
        their last reading forever). Returns the number dropped."""
        with self._lock:
            dead = [k for k in self._values
                    if dict(k).get(label) == value]
            for k in dead:
                del self._values[k]
            return len(dead)

    def _capture(self) -> Dict[str, Any]:
        """Point-in-time raw values for windowed evaluation
        (profiler/slo.py)."""
        with self._lock:
            return {"kind": self.kind, "values": dict(self._values)}

    def _expose(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"
                for k, v in items]

    def _json(self) -> Any:
        with self._lock:
            return {(_fmt_labels(k) or "total"): v
                    for k, v in self._values.items()}


class Gauge(Counter):
    """Last-write-wins value; supports inc/dec via set()."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(v)


#: default cumulative-bucket bounds (seconds — latency-shaped; +Inf is
#: implicit). Shared by external scrapers and the SLO engine, so both
#: compute the SAME quantile from the same bucket counts.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Cumulative-bucket histogram with a bounded sample reservoir.

    Exposed as a proper Prometheus ``histogram``: cumulative
    ``_bucket{le=...}`` series (``+Inf`` = count) plus ``_sum`` /
    ``_count`` — external scrapers run ``histogram_quantile()`` over
    exactly the bucket counts the in-process SLO engine windows
    (profiler/slo.py), so there is ONE quantile definition, not two.
    The reservoir (last ``max_samples`` observations per label set)
    additionally feeds the exact-percentile summaries in
    ``percentiles()`` / the JSON dump, which dashboards read."""

    kind = "histogram"
    QUANTILES = (0.5, 0.9, 0.99)

    def __init__(self, name: str, help: str = "", max_samples: int = 2048,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.help = help
        self.max_samples = max_samples
        self.bounds: Tuple[float, ...] = tuple(
            sorted(buckets if buckets is not None else DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        self._buf: Dict[Tuple, collections.deque] = {}
        self._count: Dict[Tuple, int] = collections.defaultdict(int)
        self._sum: Dict[Tuple, float] = collections.defaultdict(float)
        #: per-label NON-cumulative bucket counts, len(bounds)+1 (the
        #: last slot is the +Inf overflow); cumulated at exposure
        self._buckets: Dict[Tuple, List[int]] = {}

    def _bucket_index(self, v: float) -> int:
        return bisect.bisect_left(self.bounds, v)

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        v = float(v)
        with self._lock:
            buf = self._buf.get(key)
            if buf is None:
                buf = self._buf[key] = collections.deque(
                    maxlen=self.max_samples)
                self._buckets[key] = [0] * (len(self.bounds) + 1)
            buf.append(v)
            self._count[key] += 1
            self._sum[key] += v
            # NaN never lands in a le-bound bucket (Prometheus drops it
            # from _bucket too); it still counts in _count/_sum
            if v == v:
                self._buckets[key][self._bucket_index(v)] += 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._count.get(_label_key(labels), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sum.get(_label_key(labels), 0.0)

    def percentiles(self, **labels) -> Dict[str, float]:
        key = _label_key(labels)
        with self._lock:
            vals = sorted(self._buf.get(key, ()))
        return {f"p{int(q * 100)}": _percentile(vals, q)
                for q in self.QUANTILES}

    def remove_matching(self, label: str, value: str) -> int:
        """Drop every label set where ``label == value`` (see
        Counter.remove_matching)."""
        with self._lock:
            dead = [k for k in self._buf
                    if dict(k).get(label) == value]
            for k in dead:
                del self._buf[k]
                self._count.pop(k, None)
                self._sum.pop(k, None)
                self._buckets.pop(k, None)
            return len(dead)

    def _capture(self) -> Dict[str, Any]:
        """Point-in-time (count, sum, bucket-counts) per label set for
        windowed evaluation (profiler/slo.py). Bucket counts are the
        NON-cumulative per-bucket tallies; windowed quantiles come from
        their deltas between two captures."""
        with self._lock:
            return {"kind": self.kind, "bounds": self.bounds,
                    "series": {k: (self._count[k], self._sum[k],
                                   tuple(self._buckets.get(
                                       k, (0,) * (len(self.bounds) + 1))))
                               for k in self._buf}}

    def _expose(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            keys = sorted(self._buf)
            snap = {k: (list(self._buckets.get(
                            k, (0,) * (len(self.bounds) + 1))),
                        self._count[k], self._sum[k])
                    for k in keys}
        for k, (buckets, cnt, tot) in snap.items():
            cum = 0
            for bound, n in zip(self.bounds, buckets):
                cum += n
                bk = k + (("le", f"{bound:g}"),)
                out.append(f"{self.name}_bucket{_fmt_labels(bk)} {cum}")
            bk = k + (("le", "+Inf"),)
            out.append(f"{self.name}_bucket{_fmt_labels(bk)} "
                       f"{cum + buckets[-1]}")
            out.append(f"{self.name}_count{_fmt_labels(k)} {cnt}")
            out.append(f"{self.name}_sum{_fmt_labels(k)} {_fmt_value(tot)}")
        return out

    def _json(self) -> Any:
        with self._lock:
            keys = sorted(self._buf)
            snap = {k: (sorted(self._buf[k]), self._count[k], self._sum[k])
                    for k in keys}
        return {(_fmt_labels(k) or "total"): dict(
                    count=cnt, sum=tot,
                    **{f"p{int(q * 100)}": _percentile(vals, q)
                       for q in self.QUANTILES})
                for k, (vals, cnt, tot) in snap.items()}


class MetricsRegistry:
    """Process-wide named-metric registry (one default instance; tests
    may build private ones). get-or-create accessors are idempotent and
    thread-safe; a name registered as one kind cannot be re-registered
    as another."""

    _default: Optional["MetricsRegistry"] = None
    _default_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()

    @classmethod
    def get_default(cls) -> "MetricsRegistry":
        with cls._default_lock:
            if cls._default is None:
                cls._default = MetricsRegistry()
            return cls._default

    def _get(self, name: str, factory: Callable, kind: str):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help), "counter")

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help), "gauge")

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 2048,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(
            name, lambda: Histogram(name, help, max_samples, buckets),
            "histogram")

    def peek(self, name: str):
        """The metric if it exists, else None — a read that never
        creates (snapshot assembly must not pollute /metrics with
        empty series)."""
        with self._lock:
            return self._metrics.get(name)

    def capture(self) -> Dict[str, Any]:
        """Point-in-time raw capture of every metric — counters/gauges
        as per-label values, histograms as (count, sum, bucket counts)
        — the SLO engine's snapshot-ring unit (profiler/slo.py).
        Each metric is captured under its own lock; the capture is
        internally consistent per metric, not across metrics (windowed
        deltas don't need cross-metric atomicity)."""
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m._capture() for name, m in metrics}

    def remove_matching(self, label: str, value: str,
                        kinds: Optional[Tuple[str, ...]] = None) -> int:
        """Drop every label set with ``label == value`` across all
        metrics (optionally restricted to ``kinds``). Returns the
        number of series removed — the stale-series expiry a dying
        engine runs so its gauges don't haunt /metrics forever."""
        with self._lock:
            metrics = list(self._metrics.values())
        n = 0
        for m in metrics:
            if kinds is not None and m.kind not in kinds:
                continue
            n += m.remove_matching(label, str(value))
        return n

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4: every metric gets
        a ``# HELP`` (escaped) and ``# TYPE`` pair, label values are
        escaped, non-finite samples render as NaN/+Inf/-Inf — real
        scrapers ingest the output unmodified."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            lines.append(f"# HELP {m.name} "
                         f"{_escape_help(m.help)}".rstrip())
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m._expose())
        return "\n".join(lines) + "\n"

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: {"kind": m.kind, "help": m.help, "values": m._json()}
                for name, m in metrics}

    def reset(self) -> None:
        """Drop every metric (tests / between bench rounds)."""
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------- spans
_trace_lock = threading.Lock()
_trace_events: collections.deque = collections.deque(maxlen=50_000)
_span_stack = threading.local()
#: events evicted by the bounded buffer since the last flush into the
#: SPANS_DROPPED counter (guarded by _trace_lock — the hot path pays
#: one int increment, not a registry lookup per wrapped span)
_spans_dropped_pending = 0


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


def record_span(name: str, t0: float, t1: Optional[float] = None,
                metric: Optional[str] = None, **attrs) -> None:
    """Record one completed host span. ``t0``/``t1`` are
    ``time.perf_counter()`` readings; ``metric`` names a histogram in
    the default registry that receives the duration in SECONDS, with
    ``attrs`` as its labels."""
    if not _ENABLED:
        return
    if t1 is None:
        t1 = time.perf_counter()
    ev = {
        "name": name,
        "ph": "X",
        "ts": (t0 - _T0) * 1e6,
        "dur": max(t1 - t0, 0.0) * 1e6,
        "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if attrs:
        ev["args"] = {k: v for k, v in attrs.items()}
    global _spans_dropped_pending
    with _trace_lock:
        if _trace_events.maxlen is not None \
                and len(_trace_events) == _trace_events.maxlen:
            # the bounded buffer wrapped: the oldest event is gone, so
            # exports from here on are TRUNCATED — count it (flushed
            # into the SPANS_DROPPED counter at export time) so an
            # incomplete trace is attributable, not silently short
            _spans_dropped_pending += 1
        _trace_events.append(ev)
    if metric is not None:
        # depth/parent describe span nesting, not a metric dimension —
        # letting them through would explode the label cardinality
        labels = {k: str(v) for k, v in attrs.items()
                  if k not in ("depth", "parent")}
        MetricsRegistry.get_default().histogram(metric).observe(
            t1 - t0, **labels)


@contextlib.contextmanager
def span(name: str, metric: Optional[str] = None, **attrs):
    """Nestable host-side timing span. Nesting is tracked per thread
    and recorded as a ``depth``/``parent`` arg on the trace event, so
    perfetto's flame view reconstructs the stack from the complete
    ('X') events."""
    if not _ENABLED:
        yield
        return
    stack = getattr(_span_stack, "names", None)
    if stack is None:
        stack = _span_stack.names = []
    attrs = dict(attrs)
    attrs["depth"] = len(stack)
    if stack:
        attrs["parent"] = stack[-1]
    stack.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stack.pop()
        record_span(name, t0, metric=metric, **attrs)


def record_phase(phase: str, t0: float, t1: Optional[float] = None,
                 **attrs) -> None:
    """Step-phase helper: span + ``dl4j_tpu_step_phase_seconds`` sample
    labelled ``phase=...`` (etl_wait / device_step / listener_host)."""
    record_span(phase, t0, t1, metric=STEP_PHASE_SECONDS, phase=phase,
                **attrs)


def record_on_device_batch(site: str) -> None:
    """Count a batch that arrived in a fit loop already device-resident
    (the device prefetcher transferred it ahead of time), so the
    per-step host->device copy was skipped."""
    if not _ENABLED:
        return
    MetricsRegistry.get_default().counter(
        ON_DEVICE_BATCHES,
        "batches that arrived already device-resident (prefetched) and "
        "skipped the fit loop's host->device copy").inc(site=site)


def record_state_bytes(master_bytes: int, opt_bytes: int, mode: str,
                       site: str = "sharded") -> None:
    """Per-device fp32-master and optimizer-state byte gauges, labelled
    by sharding mode ('replicated' vs 'update_sharded') — set once at
    trainer placement time, so the 1/N memory win of update sharding is
    a measured number on /telemetry, not a claim."""
    if not _ENABLED:
        return
    reg = MetricsRegistry.get_default()
    reg.gauge(MASTER_PARAM_BYTES,
              "per-device bytes of master (update-precision) params"
              ).set(master_bytes, mode=mode, site=site)
    reg.gauge(OPT_STATE_BYTES,
              "per-device bytes of optimizer (updater) state"
              ).set(opt_bytes, mode=mode, site=site)


def timed_batches(iterable):
    """Iterate, recording time blocked on ``next()`` as the
    ``etl_wait`` phase — the one ETL-timing loop every fit front-end
    shares (MultiLayerNetwork keeps its own variant because it also
    feeds the UI's ``_last_etl_ms``)."""
    it = iter(iterable)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        record_phase("etl_wait", t0)
        yield item


def flush_dropped_spans() -> None:
    """Fold pending buffer-wrap evictions into the SPANS_DROPPED
    counter. Called by every export path (chrome_trace, snapshot, the
    UI's /metrics handler) so scrapes are exact without the record
    hot path paying a registry lookup per wrapped span."""
    global _spans_dropped_pending
    with _trace_lock:
        n, _spans_dropped_pending = _spans_dropped_pending, 0
    if n:
        MetricsRegistry.get_default().counter(
            SPANS_DROPPED,
            "trace events evicted when the bounded span buffer "
            "wrapped (exports are truncated past this point)").inc(n)


def recent_trace_events(n: int) -> List[Dict[str, Any]]:
    """The newest ``n`` trace events, copying only that slice (a full
    ``chrome_trace()`` copies the whole 50k-event buffer under the
    lock — too heavy for per-poll aggregation)."""
    import itertools

    with _trace_lock:
        k = len(_trace_events)
        if k <= n:
            return list(_trace_events)
        return list(itertools.islice(_trace_events, k - n, k))


def chrome_trace() -> Dict[str, Any]:
    """Chrome trace-event JSON object (perfetto / chrome://tracing).
    When the bounded buffer has wrapped, ``otherData.spans_dropped``
    says how many events the export is missing."""
    flush_dropped_spans()
    with _trace_lock:
        events = list(_trace_events)
    out: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    m = MetricsRegistry.get_default().peek(SPANS_DROPPED)
    if m is not None and m.total() > 0:
        out["otherData"] = {"spans_dropped": m.total()}
    return out


def export_chrome_trace(path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return path


def clear_trace() -> None:
    with _trace_lock:
        _trace_events.clear()


# ------------------------------------------------ device-memory marks
_mem_supported: Optional[bool] = None


def _cuda_index(device) -> Optional[int]:
    """The CUDA card ``device`` names (the current card for None, when
    there is one), or None for the CPU."""
    import torch

    if device is None:
        return torch.cuda.current_device() if torch.cuda.is_available() \
            else None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def sample_device_memory(device=None, force=False) -> Dict[str, Any]:
    """The card's allocator watermarks into gauges: ``bytes_in_use``
    (``allocated_bytes.all.current`` of ``torch.cuda.memory_stats``),
    ``peak_bytes_in_use`` (its ``peak``), ``bytes_reserved`` and the
    card's ``bytes_limit``.
    Returns the sample, or ``{}`` on the CPU (a CPU ``device``, or no card
    at all); the no-card verdict is cached for the default device, so the
    steady-state no-op is one attribute read. An exception from the probe
    is transient and never latches the verdict. Reads host-side allocator
    counters only: nothing is launched and nothing waits for the card.

    ``force=True`` samples even with telemetry disabled (the gauges are
    then left untouched)."""
    global _mem_supported
    if (not _ENABLED and not force) \
            or (device is None and _mem_supported is False):
        return {}
    import torch

    try:
        index = _cuda_index(device)
        if index is None:
            if device is None:
                _mem_supported = False   # no card in this process
            return {}
        stats = torch.cuda.memory_stats(index)
        total = torch.cuda.get_device_properties(index).total_memory
    except Exception:
        return {}
    if device is None:
        _mem_supported = True
    ms = {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
          "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
          "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
          "bytes_limit": int(total)}
    if _ENABLED:
        reg = MetricsRegistry.get_default()
        dev = str(index)
        reg.gauge(DEVICE_BYTES_IN_USE,
                  "current device bytes in use").set(
            ms["bytes_in_use"], device=dev)
        reg.gauge(DEVICE_PEAK_BYTES,
                  "peak device bytes in use (watermark)").set(
            ms["peak_bytes_in_use"], device=dev)
    return ms


# ------------------------------------------------------------ snapshot
def snapshot() -> Dict[str, Any]:
    """Memory watermarks, model health, state bytes and the flight
    recorder's summary as plain JSON (each part present only when it has
    something to say)."""
    reg = MetricsRegistry.get_default()
    flush_dropped_spans()
    out: Dict[str, Any] = {}
    phases = reg.peek(STEP_PHASE_SECONDS)
    if phases is not None:
        out["step_phases"] = phases._json()
    mem = sample_device_memory()
    if mem:
        out["device_memory"] = {
            "bytes_in_use": mem.get("bytes_in_use"),
            "peak_bytes_in_use": mem.get("peak_bytes_in_use"),
        }
    health = model_health_snapshot()
    if health:
        out["model_health"] = health
    state_bytes = {}
    for key, name in (("master_param_bytes", MASTER_PARAM_BYTES),
                      ("opt_state_bytes", OPT_STATE_BYTES)):
        m = reg.peek(name)
        if m is not None:
            state_bytes[key] = m._json()
    if state_bytes:
        out["state_bytes"] = state_bytes
    # the recorder imports this module: a lazy import, peek-style ({}
    # until something recorded)
    from deeplearning4j_tpu_torch.profiler import flight_recorder as _flight

    fl = _flight.snapshot()
    if fl:
        out["flight_recorder"] = fl
    m = reg.peek(SPANS_DROPPED)
    if m is not None:
        out["spans_dropped"] = m.total()
    return out


def model_health_snapshot() -> Dict[str, Any]:
    """Latest model-health gauge values (per-layer grad norms, update
    ratios, NaN provenance, MFU, step FLOPs) as plain JSON, or {} when
    no HealthMonitor has published yet. peek-only: assembling the
    snapshot never creates empty series."""
    reg = MetricsRegistry.get_default()
    out: Dict[str, Any] = {}
    for key, name in (("layer_grad_norm", LAYER_GRAD_NORM),
                      ("layer_param_norm", LAYER_PARAM_NORM),
                      ("update_ratio", UPDATE_RATIO),
                      ("nonfinite_first_layer", NONFINITE_FIRST_LAYER),
                      ("mfu", MFU),
                      ("step_flops", STEP_FLOPS),
                      ("health_fetches", HEALTH_FETCHES)):
        m = reg.peek(name)
        if m is not None:
            out[key] = m._json()
    return out


def reset() -> None:
    """Full telemetry reset: metrics, trace buffer, memory probe cache."""
    global _mem_supported, _spans_dropped_pending
    MetricsRegistry.get_default().reset()
    clear_trace()
    with _trace_lock:
        _spans_dropped_pending = 0
    _mem_supported = None


__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "span", "record_span", "record_phase", "flush_dropped_spans",
    "chrome_trace", "recent_trace_events", "export_chrome_trace",
    "clear_trace",
    "sample_device_memory", "snapshot", "timed_batches",
    "model_health_snapshot", "reset",
    "enabled", "set_enabled", "record_on_device_batch",
    "record_state_bytes",
    "DEFAULT_BUCKETS",
    "MASTER_PARAM_BYTES", "OPT_STATE_BYTES",
    "JIT_COMPILES", "JIT_COMPILE_SECONDS", "STEP_PHASE_SECONDS",
    "DEVICE_BYTES_IN_USE", "DEVICE_PEAK_BYTES",
    "PREFETCH_QUEUE_DEPTH", "TRANSFER_OVERLAP_MS",
    "PREFETCH_PADDED_EXAMPLES", "BUCKET_HITS", "BUCKET_MISSES",
    "ON_DEVICE_BATCHES",
    "LOSS_SCALE", "LOSS_SCALE_OVERFLOWS", "LOSS_SCALE_SKIPPED_STEPS",
    "PRECISION_CASTS",
    "FT_ROLLBACKS", "FT_SKIPPED_BATCHES", "FT_PREEMPTION_CHECKPOINTS",
    "FT_PERIODIC_CHECKPOINTS",
    "FT_AUTO_RESUMES", "TRANSFER_RETRIES", "TRANSFER_QUARANTINES",
    "WATCHDOG_STALLS", "CHAOS_INJECTED",
    "LAYER_GRAD_NORM", "LAYER_PARAM_NORM", "UPDATE_RATIO",
    "NONFINITE_FIRST_LAYER", "MFU", "STEP_FLOPS", "HEALTH_FETCHES",
    "PROFILE_CAPTURES",
    "SERVING_REQUESTS", "SERVING_TOKENS", "SERVING_REQUEST_LATENCY",
    "SERVING_TTFT", "SERVING_QUEUE_DEPTH", "SERVING_SLOT_OCCUPANCY",
    "SERVING_KV_PAGE_UTILIZATION", "SERVING_KV_PAGE_BYTES",
    "SERVING_WARM_HITS",
    "SERVING_WARM_MISSES", "SERVING_DECODE_STEPS",
    "SERVING_DECODE_STEP_SECONDS", "SERVING_PREFILL_SECONDS",
    "SERVING_SPEC_PROPOSED", "SERVING_SPEC_ACCEPTED",
    "SERVING_SPEC_ACCEPTANCE", "SERVING_TOKENS_PER_DISPATCH",
    "SERVING_VERIFY_SECONDS",
    "SERVING_PREFIX_HITS", "SERVING_PREFIX_MISSES",
    "SERVING_PREFIX_HIT_TOKENS", "SERVING_PREFIX_EVICTED_PAGES",
    "SERVING_PREFIX_CACHED_PAGES", "SERVING_SHARED_PAGES",
    "SERVING_PINNED_PAGES", "SERVING_SESSION_EVICTIONS",
    "SERVING_WARM_TTFT",
    "SERVING_REJECTS", "SERVING_FLEET_ROUTED",
    "SERVING_FLEET_REROUTES", "SERVING_FLEET_REPLICAS",
    "SERVING_LANE_PREFILLS", "SERVING_LANE_SECONDS",
    "SERVING_HANDOFF_SECONDS", "SERVING_FLEET_PRESSURE",
    "INFERENCE_REQUEST_LATENCY", "INFERENCE_QUEUE_DEPTH",
    "INFERENCE_BATCH_OCCUPANCY",
    "SPANS_DROPPED", "INCIDENT_DUMPS",
    "JOBS_SUBMITTED", "JOBS_FINISHED", "JOBS_RESTARTS",
    "JOBS_MIGRATIONS", "JOBS_RUNNING", "JOBS_DEVICES",
    "JOBS_THROUGHPUT", "JOBS_MFU", "JOBS_LATENCY_P50",
    "JOBS_PREEMPTIONS", "WORKER_PROCESSES", "WORKER_HEARTBEAT_AGE",
    "FT_BUNDLE_IO_RETRIES",
    "ALERTS_TOTAL", "ALERTS_ACTIVE",
]
