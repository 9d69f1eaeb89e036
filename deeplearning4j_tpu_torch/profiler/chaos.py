"""Fault injection for the training half of the resilience layer:
counterpart of ``deeplearning4j_tpu/profiler/chaos.py``.

A deterministic (seeded) chaos monkey that the guarded fit loop
(``util/resilience.py``) and the device prefetcher consult at their
fault-sensitive seams:

- ``corrupt_batch(ds, ordinal)``: the batches whose ordinal (counted per
  fit run) is in ``nan_steps`` get NaN features (the divergence guard's
  rollback-and-skip);
- ``maybe_fail_transfer()``: the prefetcher's host-to-device copy raises
  ``ChaosTransferError`` with probability ``transfer_error_rate``, each
  retry rolling again (retry with backoff, then quarantine);
- ``maybe_preempt(steps_done)``: one SIGTERM to this process, or with
  ``preempt_deadline_s`` a maintenance notice through
  ``ft.request_preemption``, when the step count reaches
  ``preempt_at_step`` (the preemption bundle and auto-resume);
- ``maybe_hang`` and ``maybe_kill``: a stalled step inside the watchdog's
  scope, and a death with no checkpoint (``WorkerKilledError``);
- ``FaultyObjectStore``: transient errors and torn uploads around an
  object-store client (the object-store bundle store's commit protocol).

Activation: ``install(ChaosMonkey(cfg))`` or the ``installed`` context
manager, else ``DL4J_TPU_CHAOS=1`` with the ``DL4J_TPU_CHAOS_*`` knobs
(read once), else none and every hook is one attribute read. Every
injection counts in ``dl4j_tpu_chaos_injected_total{kind=...}``.

Not here: ``preempt_worker`` (it drives the control plane, ROADMAP A10)
and ``hang_replica`` (the serving fleet's chaos hooks, A7.8).
"""

from __future__ import annotations

import contextlib
import logging
import os
import signal
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.profiler import telemetry as _telemetry

log = logging.getLogger("deeplearning4j_tpu_torch")


def _flight_record(kind: str, **fields) -> None:
    """Lazy flight-recorder bridge (chaos loads very early; the
    recorder import stays off the no-chaos path)."""
    from deeplearning4j_tpu_torch.profiler import flight_recorder

    flight_recorder.record(kind, **fields)


def _nan_like(a):
    """NaN of ``a``'s shape: a tensor stays a tensor on its device (a
    prefetched batch), in its float dtype or f32; anything else becomes a
    numpy array."""
    import torch

    if torch.is_tensor(a):
        dt = a.dtype if a.is_floating_point() else torch.float32
        return torch.full(a.shape, float("nan"), dtype=dt, device=a.device)
    a = np.asarray(a)
    return np.full(a.shape, np.nan,
                   a.dtype if a.dtype.kind == "f" else np.float32)


class ChaosTransferError(RuntimeError):
    """Injected transient host->device transfer failure."""


class WorkerKilledError(RuntimeError):
    """Injected SIGKILL-equivalent worker death: the fit loop dies
    mid-step with NO checkpoint, exactly as a host losing power (or a
    platform hard-kill after the grace period) would. The control
    plane's migration path recovers the newest digest-valid bundle;
    nothing in the dying run gets to clean up."""


@dataclass
class ChaosConfig:
    """What to inject and when. All fields default to 'inject nothing'
    so a config only lists the faults a test actually wants."""

    #: global batch ordinals (0-based, counted per fit run) whose
    #: features are replaced with NaN
    nan_steps: Tuple[int, ...] = ()
    #: probability each transfer ATTEMPT raises ChaosTransferError
    #: (retries re-roll; 1.0 makes a batch un-transferable -> quarantine)
    transfer_error_rate: float = 0.0
    #: raise SIGTERM in-process once this many steps have completed
    preempt_at_step: Optional[int] = None
    #: with a deadline, ``preempt_at_step`` delivers a FAKE MAINTENANCE
    #: EVENT instead of a signal: ``ft.request_preemption(deadline_s,
    #: kind="chaos_notice")`` — the notice→checkpoint→drain path is
    #: drillable without a real cluster (env spelling:
    #: ``DL4J_TPU_CHAOS_PREEMPT_AT=<step>,<deadline_s>``)
    preempt_deadline_s: Optional[float] = None
    #: stall the training step with this ordinal for ``hang_seconds``
    #: INSIDE the watchdog scope — the hung-not-dead failure mode only
    #: real hardware (a wedged collective, a dead host link) otherwise
    #: produces; the watchdog must fire, the step must then complete
    hang_step: Optional[int] = None
    hang_seconds: float = 2.0
    #: raise WorkerKilledError once this many steps have completed —
    #: SIGKILL-equivalent (no checkpoint, no cleanup), the control
    #: plane's recover-newest-bundle-and-migrate drill
    kill_at_step: Optional[int] = None
    seed: int = 20260803

    @staticmethod
    def from_env() -> Optional["ChaosConfig"]:
        if os.environ.get("DL4J_TPU_CHAOS", "0") in ("0", ""):
            return None
        raw = os.environ.get("DL4J_TPU_CHAOS_NAN_STEPS", "")
        nan_steps = tuple(int(v) for v in raw.split(",") if v.strip())
        preempt = os.environ.get("DL4J_TPU_CHAOS_PREEMPT_AT")
        hang = os.environ.get("DL4J_TPU_CHAOS_HANG_STEP")
        kill = os.environ.get("DL4J_TPU_CHAOS_KILL_AT")
        # "<step>" = raise SIGTERM; "<step>,<deadline_s>" = deliver a
        # fake maintenance NOTICE with that grace window
        preempt_deadline = None
        if preempt and "," in preempt:
            preempt, deadline_raw = preempt.split(",", 1)
            preempt_deadline = float(deadline_raw)
        return ChaosConfig(
            nan_steps=nan_steps,
            transfer_error_rate=float(
                os.environ.get("DL4J_TPU_CHAOS_TRANSFER_P", "0") or 0),
            preempt_at_step=int(preempt) if preempt else None,
            preempt_deadline_s=preempt_deadline,
            hang_step=int(hang) if hang else None,
            hang_seconds=float(
                os.environ.get("DL4J_TPU_CHAOS_HANG_SECONDS", "2") or 2),
            kill_at_step=int(kill) if kill else None,
            seed=int(os.environ.get("DL4J_TPU_CHAOS_SEED", "20260803")),
        )


class ChaosMonkey:
    """Stateful injector for one ChaosConfig. Thread-safe: the transfer
    hook runs on the prefetcher's worker thread while the batch/preempt
    hooks run on the fit-loop thread."""

    def __init__(self, config: ChaosConfig):
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        self._lock = threading.Lock()
        self._preempted = False
        self._hung = False
        self._killed = False

    def _record(self, kind: str) -> None:
        if not _telemetry.enabled():
            return
        _telemetry.MetricsRegistry.get_default().counter(
            _telemetry.CHAOS_INJECTED,
            "faults injected by the chaos harness").inc(kind=kind)

    # ------------------------------------------------------------ hooks
    def corrupt_batch(self, ds, ordinal: int):
        """Return ``ds`` with NaN features when ``ordinal`` is a
        configured NaN step; otherwise ``ds`` unchanged. Never mutates
        the caller's batch — the original survives for a post-rollback
        inspection."""
        if ordinal not in self.config.nan_steps:
            return ds
        self._record("nan_batch")
        log.warning("CHAOS: injecting NaN batch at ordinal %d", ordinal)
        from deeplearning4j_tpu_torch.datasets.dataset import DataSet
        from deeplearning4j_tpu_torch.datasets.multi_dataset import (
            MultiDataSet)

        if isinstance(ds, MultiDataSet):
            return MultiDataSet([_nan_like(a) for a in ds.features],
                                list(ds.labels),
                                ds.features_mask_arrays or None,
                                ds.labels_mask_arrays or None)
        if isinstance(ds, DataSet):
            return DataSet(_nan_like(ds.features), ds.labels,
                           ds.features_mask, ds.labels_mask)
        return _nan_like(ds)

    def maybe_fail_transfer(self) -> None:
        """Raise ChaosTransferError with the configured probability."""
        p = self.config.transfer_error_rate
        if p <= 0.0:
            return
        with self._lock:   # default_rng is not thread-safe
            roll = self._rng.random()
        if roll < p:
            self._record("transfer_error")
            raise ChaosTransferError(
                "injected transient host->device transfer failure "
                f"(p={p})")

    def maybe_hang(self, steps_done: int) -> None:
        """Stall the current step once, for ``hang_seconds``, when the
        configured step count is reached. Called INSIDE the fit loop's
        watchdog scope, so a deadline shorter than the hang sees a real
        stall verdict (watchdog fires, stall counter bumps, incident
        dump) while the step itself eventually completes — hung, not
        dead."""
        at = self.config.hang_step
        if at is None or self._hung or steps_done < at:
            return
        self._hung = True
        self._record("hang")
        log.warning("CHAOS: hanging step %d for %.1fs (watchdog drill)",
                    steps_done, self.config.hang_seconds)
        import time

        time.sleep(self.config.hang_seconds)

    def maybe_kill(self, steps_done: int) -> None:
        """Raise WorkerKilledError once at the configured step count —
        the SIGKILL-equivalent death: the exception escapes the fit
        loop with no checkpoint written, and recovery is whatever the
        newest periodic bundle holds."""
        at = self.config.kill_at_step
        if at is None or self._killed or steps_done < at:
            return
        self._killed = True
        self._record("worker_kill")
        log.warning("CHAOS: killing worker after %d steps (no "
                    "checkpoint — SIGKILL-equivalent)", steps_done)
        raise WorkerKilledError(
            f"chaos worker kill after {steps_done} steps")

    def maybe_preempt(self, steps_done: int, ft=None) -> None:
        """Deliver one preemption at the configured step count. With
        no ``preempt_deadline_s``: one real SIGTERM — the fit loop's
        installed handler turns it into a clean checkpoint-and-exit.
        With a deadline (and the loop's FaultTolerance passed in): a
        FAKE MAINTENANCE EVENT — ``ft.request_preemption(deadline_s,
        kind="chaos_notice")`` — so the notice→checkpoint→drain path
        is drillable without a real cluster."""
        at = self.config.preempt_at_step
        if at is None or self._preempted or steps_done < at:
            return
        self._preempted = True
        deadline = self.config.preempt_deadline_s
        if deadline is not None and ft is not None:
            self._record("preempt_notice")
            _flight_record("chaos_injected", fault="preempt_notice",
                           deadline_s=deadline, step=steps_done)
            log.warning("CHAOS: delivering fake maintenance notice "
                        "after %d steps (deadline %.1fs)", steps_done,
                        deadline)
            ft.request_preemption(deadline_s=deadline,
                                  kind="chaos_notice")
            return
        self._record("preemption")
        log.warning("CHAOS: simulating preemption after %d steps "
                    "(raising SIGTERM)", steps_done)
        signal.raise_signal(signal.SIGTERM)


# ------------------------------------------------------------ activation
_active: Optional[ChaosMonkey] = None
_env_checked = False
_lock = threading.Lock()


def active() -> Optional[ChaosMonkey]:
    """The installed monkey, the env-configured one, or None."""
    global _active, _env_checked
    if _active is not None:
        return _active
    if not _env_checked:
        with _lock:
            if not _env_checked:
                cfg = ChaosConfig.from_env()
                if cfg is not None:
                    _active = ChaosMonkey(cfg)
                    log.warning("CHAOS harness active from env: %s", cfg)
                _env_checked = True
    return _active


def install(monkey: Optional[ChaosMonkey]) -> None:
    """Install (or with None, remove) the process-wide chaos monkey."""
    global _active
    _active = monkey


@contextlib.contextmanager
def installed(config: ChaosConfig):
    """Scoped activation for tests: install a fresh monkey for the
    block, restore whatever was active before on exit."""
    global _active
    prev = _active
    monkey = ChaosMonkey(config)
    _active = monkey
    try:
        yield monkey
    finally:
        _active = prev


class FaultyObjectStore:
    """Chaos wrapper for object-store clients
    (``util.resilience.InMemoryObjectStore`` and friends): injects the
    failure shapes real S3/GCS traffic sees — per-op transient errors
    and TORN UPLOADS (the connection dies mid-PUT, leaving a truncated
    blob under the key) — so the rename-less commit protocol's claims
    (write retry, partial-upload invisibility, digest-based fallback)
    are proven, not assumed.

    - ``error_rate``: probability each op in ``ops`` raises OSError
      before touching the inner store. A rate ``>= 1.0`` switches to
      the deterministic drill mode: the FIRST attempt of every
      distinct ``(op, key)`` fails and the retry succeeds — every
      bundle op retries at least once, nothing ever wedges (what the
      CI drill sets via ``DL4J_TPU_CHAOS_STORE_ERROR_RATE=1``).
    - ``torn_rate``: probability (same ``>= 1.0`` drill semantics) a
      PUT writes only the first half of the payload to the inner
      store and then raises — the torn blob EXISTS remotely; only
      digest validation can tell. A retried put overwrites it whole
      (last-write-wins, the S3 model).
    - ``ops``: which of put/get/list/delete inject errors (default
      all).

    Env activation (``from_env``): ``DL4J_TPU_CHAOS_STORE_ERROR_RATE``,
    ``DL4J_TPU_CHAOS_STORE_TORN_RATE``, ``DL4J_TPU_CHAOS_STORE_OPS``
    (comma-separated), ``DL4J_TPU_CHAOS_STORE_SEED``. Standalone knobs
    — no ``DL4J_TPU_CHAOS`` master switch needed: a store-chaos drill
    should not also enable NaN/preemption injection. Every injection
    lands in ``dl4j_tpu_chaos_injected_total{kind=store_*}`` plus a
    flight-recorder event."""

    _OPS = ("put", "get", "list", "delete")

    def __init__(self, inner, *, error_rate: float = 0.0,
                 torn_rate: float = 0.0, ops=None,
                 seed: Optional[int] = None):
        self.inner = inner
        self.error_rate = float(error_rate)
        self.torn_rate = float(torn_rate)
        self.ops = tuple(ops) if ops else self._OPS
        self._rng = np.random.default_rng(
            20260807 if seed is None else seed)
        self._fault_lock = threading.Lock()
        #: (kind, op, key) triples already failed once — the
        #: deterministic rate>=1.0 drill mode's memory
        self._failed_once = set()
        self.injected = 0

    @staticmethod
    def from_env(inner, environ=None):
        """Wrap ``inner`` per the ``DL4J_TPU_CHAOS_STORE_*`` env knobs
        — or return it untouched when none are set."""
        env = os.environ if environ is None else environ
        err = float(
            env.get("DL4J_TPU_CHAOS_STORE_ERROR_RATE", "0") or 0)
        torn = float(
            env.get("DL4J_TPU_CHAOS_STORE_TORN_RATE", "0") or 0)
        if err <= 0.0 and torn <= 0.0:
            return inner
        ops = tuple(
            v.strip()
            for v in env.get("DL4J_TPU_CHAOS_STORE_OPS", "").split(",")
            if v.strip()) or None
        seed = env.get("DL4J_TPU_CHAOS_STORE_SEED")
        store = FaultyObjectStore(
            inner, error_rate=err, torn_rate=torn, ops=ops,
            seed=int(seed) if seed else None)
        log.warning("CHAOS: object-store fault injection active "
                    "(error_rate=%s, torn_rate=%s, ops=%s)",
                    err, torn, store.ops)
        return store

    # ------------------------------------------------------- injection
    def _roll(self, kind: str, op: str, key, rate: float) -> bool:
        if rate <= 0.0 or op not in self.ops:
            return False
        if rate >= 1.0:
            with self._fault_lock:
                mark = (kind, op, str(key))
                if mark in self._failed_once:
                    return False
                self._failed_once.add(mark)
                return True
        with self._fault_lock:       # default_rng is not thread-safe
            return float(self._rng.random()) < rate

    def _inject(self, kind: str, op: str, key) -> None:
        self.injected += 1
        if _telemetry.enabled():
            _telemetry.MetricsRegistry.get_default().counter(
                _telemetry.CHAOS_INJECTED,
                "faults injected by the chaos harness").inc(kind=kind)
        _flight_record("chaos_injected", fault=kind, op=op,
                       key=str(key)[-160:])
        log.warning("CHAOS: injected %s on object-store %s %s",
                    kind, op, key)

    # ------------------------------------------------------ client api
    def put(self, key, data) -> None:
        if self._roll("store_torn", "put", key, self.torn_rate):
            self._inject("store_torn", "put", key)
            # the half-written blob LANDS — invisible only because no
            # commit/digest ever blesses it
            self.inner.put(key, bytes(data[:max(1, len(data) // 2)]))
            raise OSError(f"chaos: torn upload of {key}")
        if self._roll("store_error", "put", key, self.error_rate):
            self._inject("store_error", "put", key)
            raise OSError(f"chaos: injected put failure for {key}")
        return self.inner.put(key, data)

    def get(self, key):
        if self._roll("store_error", "get", key, self.error_rate):
            self._inject("store_error", "get", key)
            raise OSError(f"chaos: injected get failure for {key}")
        return self.inner.get(key)

    def list(self, prefix):
        if self._roll("store_error", "list", prefix, self.error_rate):
            self._inject("store_error", "list", prefix)
            raise OSError(
                f"chaos: injected list failure for {prefix}")
        return self.inner.list(prefix)

    def delete(self, key) -> None:
        if self._roll("store_error", "delete", key, self.error_rate):
            self._inject("store_error", "delete", key)
            raise OSError(
                f"chaos: injected delete failure for {key}")
        return self.inner.delete(key)

    def describe(self) -> str:
        inner = getattr(self.inner, "describe", None)
        return (f"faulty({inner() if callable(inner) else self.inner},"
                f" err={self.error_rate}, torn={self.torn_rate})")


__all__ = ["ChaosConfig", "ChaosMonkey", "ChaosTransferError",
           "FaultyObjectStore", "WorkerKilledError", "active", "install",
           "installed"]
