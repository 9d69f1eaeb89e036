"""Black-box flight recorder: counterpart of
``deeplearning4j_tpu/profiler/flight_recorder.py`` (host only).

- ``record(kind, **fields)`` appends one structured event (monotonic
  ``seq``, wall-clock ``t``, free-form fields) to a bounded ring. The
  guarded fit loop records per-step losses (it reads the loss anyway) and
  every fault-tolerance event. ``DL4J_TPU_FLIGHT=0`` opts out.
- ``incident(reason, **context)`` appends a terminal event and dumps the
  ring atomically: ``events.jsonl``, ``trace.json`` (the Chrome-trace
  snapshot of ``profiler.telemetry``), ``requests.json`` (request
  timelines: empty lists until serving tracing is ported, ROADMAP A7.7)
  and a ``manifest.json`` with the sha256 of every member, written into a
  dot-tmp directory, fsynced and renamed into place.
- ``load_dump(path)`` verifies the digests and parses everything back.

Dump triggers: the watchdog, the divergence guard (rollback and
budget-exhausted abort), the preemption checkpoint and, through
``install_excepthook()``, an unhandled exception.

Dump location: the ``directory=`` argument, else the ``configure()``d
directory, else ``$DL4J_TPU_FLIGHT_DIR``, else
``<tempdir>/dl4j_tpu_flight``.
"""

from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import shutil
import socket
import sys
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.profiler import telemetry as _telemetry

log = logging.getLogger("deeplearning4j_tpu_torch")

_FORMAT = "dl4j-tpu-flight-1"
_DEFAULT_CAPACITY = 512


def _sanitize(v, depth: int = 0):
    """JSON-safe coercion that never touches a device: numbers become
    plain floats/ints (non-finite floats become their string spelling —
    a NaN loss is exactly what an incident dump must preserve, and bare
    NaN is not JSON), everything unknown becomes a capped repr. The
    depth bound is a runaway guard only — requests.json legitimately
    nests root -> timeline list -> timeline -> events -> event ->
    attr value (depth 5), which must survive as structure."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):
        return v if v == v and abs(v) != float("inf") else repr(v)
    if isinstance(v, dict) and depth < 8:
        return {str(k): _sanitize(x, depth + 1) for k, x in v.items()}
    if isinstance(v, (list, tuple)) and depth < 8:
        return [_sanitize(x, depth + 1) for x in v]
    item = getattr(v, "item", None)
    if item is not None and getattr(v, "ndim", 1) == 0:
        try:
            return _sanitize(item())
        except Exception:
            pass
    return repr(v)[:200]


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class FlightRecorder:
    """One bounded event ring + its dump machinery. A process normally
    uses the default instance (module-level helpers); tests may build
    private ones."""

    #: dumps retained per directory — a watchdog deadline set slightly
    #: too low must not fill the checkpoint volume with fsynced dumps
    #: (same keep-last discipline as resilience bundles)
    KEEP_DUMPS = 16

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 directory: Optional[str] = None,
                 enabled: Optional[bool] = None):
        self.capacity = int(capacity)
        self.directory = directory
        self.enabled = (os.environ.get("DL4J_TPU_FLIGHT", "1") != "0"
                        if enabled is None else bool(enabled))
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.incidents: collections.deque = collections.deque(maxlen=16)
        self.last_dump: Optional[str] = None

    # ------------------------------------------------------- recording
    def record(self, kind: str, **fields) -> None:
        if not self.enabled:
            return
        ev = {"seq": 0, "t": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._ring.append(ev)

    def record_step(self, site: str, iteration: int, t0: float,
                    **fields) -> None:
        """Per-training-step convenience: dispatch time derived from
        the step's start perf_counter reading."""
        if not self.enabled:
            return
        self.record("train_step", site=site, iteration=int(iteration),
                    dispatch_ms=round((time.perf_counter() - t0) * 1e3, 3),
                    **fields)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    # --------------------------------------------------------- dumping
    def incident(self, reason: str, directory: Optional[str] = None,
                 **context) -> Optional[str]:
        """Terminal event + atomic dump. Never raises: a broken disk
        must not take down the training loop the recorder exists to
        explain. Returns the dump path, or None (disabled / failed)."""
        if not self.enabled:
            return None
        term = {"seq": 0, "t": time.time(), "kind": reason}
        term.update({k: _sanitize(v) for k, v in context.items()})
        with self._lock:
            self._seq += 1
            term["seq"] = self._seq
            self._ring.append(term)
            events = list(self._ring)
        try:
            path = self._dump(reason, events, directory, context)
        except Exception:
            log.exception("flight recorder: dump for %r failed", reason)
            return None
        self.incidents.append({"reason": reason, "path": path,
                               "wall_time": term["t"]})
        self.last_dump = path
        if _telemetry.enabled():
            _telemetry.MetricsRegistry.get_default().counter(
                _telemetry.INCIDENT_DUMPS,
                "flight-recorder incident dumps written").inc(
                reason=reason)
        log.error("FLIGHT RECORDER: incident %r — %d events dumped to %s",
                  reason, len(events), path)
        return path

    def _resolve_dir(self, directory: Optional[str]) -> str:
        return (directory or self.directory
                or os.environ.get("DL4J_TPU_FLIGHT_DIR")
                or os.path.join(tempfile.gettempdir(), "dl4j_tpu_flight"))

    def _dump(self, reason: str, events: List[Dict[str, Any]],
              directory: Optional[str], context: Dict[str, Any]) -> str:
        from deeplearning4j_tpu_torch.util.model_serializer import (
            fsync_directory)

        root = self._resolve_dir(directory)
        os.makedirs(root, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        name = (f"incident-{stamp}-{reason}-{os.getpid()}-"
                f"{uuid.uuid4().hex[:6]}")
        final = os.path.join(root, name)
        tmp = os.path.join(root, f".{name}.tmp")
        os.makedirs(tmp)

        def _write(member: str, text: str) -> None:
            with open(os.path.join(tmp, member), "w") as f:
                f.write(text)
                f.flush()
                os.fsync(f.fileno())

        try:
            _write("events.jsonl", "".join(
                json.dumps(_sanitize(ev)) + "\n" for ev in events))
            # cap the trace snapshot: a long-lived process holds up to
            # 50k span events (~10MB of JSON) and the dump must stay
            # fast enough to finish inside a SIGTERM grace period —
            # the newest slice is the forensically relevant one
            trace = _telemetry.chrome_trace()
            tev = trace["traceEvents"]
            if len(tev) > 5000:
                trace = dict(trace, traceEvents=tev[-5000:])
                trace.setdefault("otherData", {})
                trace["otherData"] = dict(
                    trace["otherData"],
                    dump_truncated_events=len(tev) - 5000)
            _write("trace.json", json.dumps(trace))
            # no request tracing in the port yet (ROADMAP A7.7): the
            # member keeps the JAX dump's layout
            _write("requests.json", json.dumps({"live": [], "recent": []}))
            members = ["events.jsonl", "trace.json", "requests.json"]
            _write("manifest.json", json.dumps({
                "format": _FORMAT,
                "reason": reason,
                "wall_time": time.time(),
                "pid": os.getpid(),
                "host": socket.gethostname(),
                "event_count": len(events),
                "last_seq": events[-1]["seq"] if events else 0,
                "context": _sanitize(context),
                "digests": {m: _sha256(os.path.join(tmp, m))
                            for m in members},
            }))
            fsync_directory(tmp)
            os.replace(tmp, final)
            fsync_directory(root)
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp, ignore_errors=True)
        for old in list_dumps(root)[:-self.KEEP_DUMPS]:
            shutil.rmtree(old, ignore_errors=True)
        return final

    def snapshot(self) -> Dict[str, Any]:
        """/telemetry + bench embedding: {} until something recorded
        (peek-style — a process that never records shows nothing)."""
        with self._lock:
            n, last_seq = len(self._ring), self._seq
        if not self.enabled or (last_seq == 0 and not self.incidents):
            return {}
        return {
            "enabled": self.enabled,
            "events": n,
            "capacity": self.capacity,
            "last_seq": last_seq,
            "last_incident": self.last_dump,
            "incidents": list(self.incidents),
        }


# ---------------------------------------------------------- dump loader
def load_dump(path: str) -> Dict[str, Any]:
    """Parse an incident dump back; ``valid`` is True iff the manifest
    parses, the format matches, and every member's sha256 digest
    verifies — the same digest discipline resume bundles use."""
    out: Dict[str, Any] = {"path": path, "valid": False,
                           "manifest": None, "events": [],
                           "trace": None, "requests": None,
                           "programs": None, "metrics": None}
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out["manifest"] = manifest
        valid = manifest.get("format") == _FORMAT
        for member, digest in manifest.get("digests", {}).items():
            if _sha256(os.path.join(path, member)) != digest:
                valid = False
        out["valid"] = valid
    except (OSError, ValueError, KeyError):
        return out
    try:
        with open(os.path.join(path, "events.jsonl")) as f:
            out["events"] = [json.loads(line) for line in f
                             if line.strip()]
        with open(os.path.join(path, "trace.json")) as f:
            out["trace"] = json.load(f)
        with open(os.path.join(path, "requests.json")) as f:
            out["requests"] = json.load(f)
        if "programs.json" in (out["manifest"].get("digests") or {}):
            with open(os.path.join(path, "programs.json")) as f:
                out["programs"] = json.load(f)
        if "metrics.json" in (out["manifest"].get("digests") or {}):
            with open(os.path.join(path, "metrics.json")) as f:
                out["metrics"] = json.load(f)
    except (OSError, ValueError):
        out["valid"] = False
    return out


def list_dumps(directory: str) -> List[str]:
    """Incident dump dirs under ``directory``, newest name last."""
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("incident-"))
    except OSError:
        return []
    return [os.path.join(directory, n) for n in names]


# --------------------------------------------------- default instance
_default: Optional[FlightRecorder] = None
_dlock = threading.Lock()


def get_default() -> FlightRecorder:
    global _default
    with _dlock:
        if _default is None:
            _default = FlightRecorder()
        return _default


def configure(directory: Optional[str] = None,
              capacity: Optional[int] = None,
              enabled: Optional[bool] = None) -> FlightRecorder:
    """Adjust the default recorder in place (capacity changes re-home
    the ring, keeping the newest events)."""
    r = get_default()
    with r._lock:
        if directory is not None:
            r.directory = directory
        if enabled is not None:
            r.enabled = bool(enabled)
        if capacity is not None and int(capacity) != r.capacity:
            r.capacity = int(capacity)
            r._ring = collections.deque(r._ring, maxlen=r.capacity)
    return r


def record(kind: str, **fields) -> None:
    # fast path: skip the default-instance lock on the per-step call
    r = _default
    (r if r is not None else get_default()).record(kind, **fields)


def record_step(site: str, iteration: int, t0: float, **fields) -> None:
    r = _default
    (r if r is not None else get_default()).record_step(
        site, iteration, t0, **fields)


def incident(reason: str, directory: Optional[str] = None,
             **context) -> Optional[str]:
    return get_default().incident(reason, directory=directory, **context)


def snapshot() -> Dict[str, Any]:
    return get_default().snapshot()


def reset() -> None:
    """Fresh default recorder (tests / between bench rounds)."""
    global _default
    with _dlock:
        _default = None


# ------------------------------------------------- unhandled exceptions
_hook_installed = False
_in_hook = False


def install_excepthook() -> None:
    """Chain onto ``sys.excepthook`` so a process dying with an
    unhandled exception leaves an incident dump behind. Idempotent;
    the previous hook always runs afterwards."""
    global _hook_installed
    with _dlock:
        if _hook_installed:
            return
        _hook_installed = True
    prev = sys.excepthook

    def _hook(exc_type, exc, tb):
        global _in_hook
        if not _in_hook:
            _in_hook = True
            try:
                incident("unhandled_exception",
                         error=f"{exc_type.__name__}: {exc}"[:400])
            except Exception:
                pass
            finally:
                _in_hook = False
        prev(exc_type, exc, tb)

    sys.excepthook = _hook


__all__ = ["FlightRecorder", "get_default", "configure", "record",
           "record_step", "incident", "snapshot", "reset", "load_dump",
           "list_dumps", "install_excepthook"]
