"""Fault-tolerant training: counterpart of
``deeplearning4j_tpu/util/resilience.py`` for the port's
``MultiLayerNetwork`` and ``ComputationGraph``.

- **Preemption bundles.** SIGTERM / SIGINT (or
  ``FaultTolerance.request_preemption``, or a maintenance notice) set a
  flag; at the next step boundary the loop writes one atomic bundle,
  ``bundle-<iteration>/{model.zip, resume.json, manifest.json}``, and
  returns. ``model.zip`` is the ModelSerializer zip both packages read
  (parameters, layer state, updater state, loss-scale state, counters);
  ``resume.json`` holds the iterator's position, the epochs left and the
  model's ``torch.Generator`` state; ``manifest.json`` the sha256 of each
  member. The JAX package's ``validate_bundle`` accepts these bundles,
  and this module resumes the JAX package's.
- **Auto-resume.** ``fit(..., auto_resume=dir)`` restores the newest
  bundle whose digests verify (falling back past a torn one) and goes on
  with the next batch; a finished run retires its bundles.
- **Divergence guard.** A rolling window of losses: a non-finite loss,
  or a spike past ``spike_factor`` times the window's median, rolls the
  model back to an in-memory snapshot on the card and skips the batch,
  up to ``max_rollbacks``, then raises ``DivergenceError``. The guard
  reads the loss back once a step; ``divergence_window=0`` turns it off.
  The snapshot clones every tensor (parameters, layer state, updater
  state, loss-scale state) and the generator's state: the step replaces
  the trees, but a rollback must never hand back a tensor that a later
  in-place write could reach.
- **Step watchdog.** A step past ``step_deadline`` seconds logs every
  thread's stack and a telemetry snapshot, counts a stall and dumps the
  flight recorder, without stopping the step.
- **Transfer retries.** A ``DevicePrefetchIterator`` feeding the loop
  gets retries with backoff and poison-batch quarantine for the fit.

Without ``fault_tolerance`` / ``auto_resume`` the networks' ``fit`` runs
its own loop and this module is not imported.

Not here: sharded trainers (their mesh topology, ZeRO shard members and
the multi-host shard publication raise ``not_ported(..., "A8")``).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import random
import re
import shutil
import signal
import statistics
import sys
import tempfile
import threading
import time
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import not_ported
from deeplearning4j_tpu_torch.profiler import chaos as _chaos
from deeplearning4j_tpu_torch.profiler import flight_recorder as _flight
from deeplearning4j_tpu_torch.profiler import telemetry as _telemetry

log = logging.getLogger("deeplearning4j_tpu_torch")

_BUNDLE_RE = re.compile(r"bundle-(\d+)(?:-\d+)?$")
_RESUME_FORMAT = "deeplearning4j_tpu-ft-1"


class DivergenceError(RuntimeError):
    """Raised when the divergence guard exhausts its rollback budget —
    the run is not recovering, a human needs to look."""


# ======================================================================
# resumable checkpoint bundles
# ======================================================================
def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _sharded(trainer, what: str):
    """``not_ported`` for a sharded trainer (ROADMAP A8)."""
    return not_ported(f"{what} of a sharded trainer", "A8")


def _mesh_topology(trainer) -> Optional[Dict[str, Any]]:
    """The manifest's mesh record: None for a single-device model (a
    sharded trainer's mesh comes with A8)."""
    if trainer is None:
        return None
    raise _sharded(trainer, "the bundle's mesh topology")


def _write_zero_shards(tmp: str, trainer) -> Optional[str]:
    """The ZeRO shard member of a sharded trainer's bundle (A8); nothing
    for a single-device model."""
    if trainer is None:
        return None
    raise _sharded(trainer, "the ZeRO shard member")


def _host_identity() -> Tuple[int, int]:
    """(rank, world size) of this process in ``torch.distributed`` when
    a process group is up, else (0, 1)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank()), int(dist.get_world_size())
    except Exception:
        pass
    return 0, 1


def write_bundle(directory: str, model, resume_meta: Dict[str, Any],
                 keep_last: int = 2, trainer=None,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 host: Optional[str] = None) -> str:
    """Write one atomic resumable bundle under ``directory`` and prune
    to the newest ``keep_last``. Layout::

        bundle-<iteration>/
            model.zip      ModelSerializer archive (params + updater +
                           loss-scale + iteration/epoch)
            resume.json    RNG key, iterator position, epochs remaining
            manifest.json  sha256 digests of the members + the mesh
                           topology the bundle was saved under
            zero_shards_p<i>.npz   (update-sharded trainers only) this
                           host's addressable master/opt flat shards

    Atomicity: everything is written into a writer-unique temp
    directory, each file fsynced, then the directory is renamed into
    place and the parent fsynced — a crash mid-save leaves only a temp
    dir that discovery ignores, never a half bundle under a valid name.
    ``keep_last >= 2`` is what makes digest-verified fallback possible:
    if the newest bundle is torn, the previous one still restores."""
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer, fsync_directory)

    os.makedirs(directory, exist_ok=True)
    iteration = int(model.getIterationCount())
    name = f"bundle-{iteration:010d}"
    final = os.path.join(directory, name)
    n = 0
    while os.path.exists(final):   # re-preemption at the same step
        n += 1
        final = os.path.join(directory, f"{name}-{n}")
    tmp = os.path.join(directory,
                       f".{name}.{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp")
    os.makedirs(tmp)

    def _write_member(member: str, obj) -> None:
        # plain write + fsync: the tmp dir is unpublished (discovery
        # ignores dot-dirs), so the single publish point is the
        # directory rename below — per-member rename dances would buy
        # no extra crash-safety, just fsync cycles spent inside the
        # SIGTERM grace period
        with open(os.path.join(tmp, member), "w") as f:
            json.dump(obj, f)
            f.flush()
            os.fsync(f.fileno())

    if process_index is None or process_count is None:
        pidx, pcnt = _host_identity()
        process_index = pidx if process_index is None else process_index
        process_count = pcnt if process_count is None else process_count
    try:
        # writeModel is itself atomic (temp + fsync + replace) inside tmp
        ModelSerializer.writeModel(model, os.path.join(tmp, "model.zip"))
        _write_member("resume.json", dict(resume_meta,
                                          format=_RESUME_FORMAT))
        members = ["model.zip", "resume.json"]
        zmember = _write_zero_shards(tmp, trainer)
        if zmember is not None:
            members.append(zmember)
        manifest = {
            "format": _RESUME_FORMAT,
            "iteration": iteration,
            "mesh": _mesh_topology(trainer),
            "host": host if host is not None
            else f"p{process_index}",
            "digests": {m: _sha256(os.path.join(tmp, m))
                        for m in members},
        }
        shared_protocol = zmember is not None and process_count > 1
        if shared_protocol:
            # shared-filesystem contract: every host owns one shard
            # member, and a bundle is COMPLETE only when all of them
            # have been published (foreign shards carry .sha256
            # sidecars — see publish_foreign_shard / _bundle_complete)
            manifest["expected_shards"] = [
                f"zero_shards_p{i}.npz" for i in range(process_count)]
        _write_member("manifest.json", manifest)
        fsync_directory(tmp)
        os.replace(tmp, final)
        fsync_directory(directory)
    finally:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
    # the process-0-only pruning rule exists for the SHARED multi-host
    # shard protocol (a peer's still-publishing shard must not be
    # pruned out from under it); hosts writing independent full
    # bundles (no expected_shards) keep the historical per-host
    # keep_last enforcement — their directories may be private disks
    _prune_bundles(directory, keep_last,
                   process_index=process_index if shared_protocol
                   else 0)
    return final


def _list_bundles(directory: str) -> List[Tuple[int, str]]:
    """(iteration, path) for every bundle dir, newest first."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for nm in names:
        m = _BUNDLE_RE.fullmatch(nm)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, nm)))
    # name (with its -k re-preemption suffix) breaks iteration ties in
    # creation order
    return sorted(out, key=lambda t: (t[0], t[1]), reverse=True)


def _bundle_complete(path: str) -> bool:
    """Cheap multi-host completeness probe (NO digest pass): the
    manifest parses and every expected per-host shard member is
    present with its integrity record (manifest digest for the
    writing host, ``.sha256`` sidecar for foreign hosts). Single-host
    bundles have no ``expected_shards`` and are complete iff the
    manifest parses."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != _RESUME_FORMAT:
            return False
        digests = manifest.get("digests", {})
        for member in manifest.get("expected_shards", []):
            if not os.path.exists(os.path.join(path, member)):
                return False
            if member not in digests and not os.path.exists(
                    os.path.join(path, member + ".sha256")):
                return False
        return True
    except (OSError, ValueError):
        return False


def _prune_bundles(directory: str, keep_last: int,
                   process_index: Optional[int] = None) -> None:
    """keep_last enforcement, multi-host safe: ONLY process 0 prunes
    (each host pruning independently is a race against a slower host
    still publishing its shard), keep_last counts only COMPLETE
    bundles (every expected per-host shard present — see
    ``_bundle_complete``), and an incomplete bundle at or newer than
    the pruning cutoff is never deleted: it is a slower host's
    still-being-written checkpoint, not garbage. Incomplete bundles
    OLDER than the cutoff are torn leftovers and go."""
    if process_index is None:
        process_index = _host_identity()[0]
    if process_index != 0:
        return
    bundles = _list_bundles(directory)
    complete = [(it, p) for it, p in bundles if _bundle_complete(p)]
    if not complete:
        return
    kept = complete[:max(keep_last, 1)]
    keep = {p for _, p in kept}
    cutoff = kept[-1][0]        # iteration of the oldest kept bundle
    for it, path in bundles:
        if path in keep:
            continue
        if it >= cutoff and not _bundle_complete(path):
            continue            # a slow host may still be publishing
        shutil.rmtree(path, ignore_errors=True)


def _await_bundle_for_iteration(directory: str, iteration: int,
                                member: str,
                                timeout_s: float) -> str:
    """The bundle dir a NON-zero host must attach its shard to: the
    newest dir process 0 published for ``iteration`` that does not
    yet hold ``member``. Resolved by LISTING, never by recomputing
    the name — a re-preemption at the same step makes process 0
    publish a ``-k``-suffixed dir, and writing the shard into the
    unsuffixed older one would corrupt a bundle that already
    validated."""
    deadline = time.monotonic() + timeout_s
    while True:
        cands = [p for it, p in _list_bundles(directory)
                 if it == iteration]
        # _list_bundles sorts suffixed (newer) dirs first at equal
        # iteration; prefer the newest one still missing our shard
        for p in cands:
            if not os.path.exists(os.path.join(p, member)):
                return p
        if cands:
            return cands[0]
        if time.monotonic() > deadline:
            raise OSError(
                f"no bundle for iteration {iteration} was published "
                f"by process 0 within {timeout_s}s — cannot attach "
                f"shard {member}")
        time.sleep(0.05)


def publish_foreign_shard(directory: str, iteration: int, member: str,
                          data: Dict[str, np.ndarray],
                          timeout_s: float = 10.0) -> str:
    """Shared-filesystem shard publish for a NON-zero host: wait for
    process 0 to rename the bundle directory into place, then publish
    this host's ``zero_shards_p<i>.npz`` next to it atomically
    (unique tmp + fsync + replace) with a ``.sha256`` sidecar so any
    survivor can digest-verify it without this host."""
    bundle_path = _await_bundle_for_iteration(directory, iteration,
                                              member, timeout_s)
    from deeplearning4j_tpu_torch.util.model_serializer import (
        fsync_directory, unique_tmp_path)

    final = os.path.join(bundle_path, member)
    tmp = unique_tmp_path(final)
    with open(tmp, "wb") as f:
        np.savez(f, **data)
        f.flush()
        os.fsync(f.fileno())
    digest = _sha256(tmp)
    with open(tmp + ".sha", "w") as f:
        f.write(digest)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp + ".sha", final + ".sha256")
    os.replace(tmp, final)
    fsync_directory(bundle_path)
    return final


def validate_bundle(path: str, raise_io: bool = False) -> bool:
    """True iff the manifest parses and every member's sha256 matches —
    the corruption detector behind newest-valid discovery. Foreign
    per-host shards (``expected_shards`` beyond this host's manifest
    digests) verify against their ``.sha256`` sidecars. With
    ``raise_io`` an OSError propagates instead of reading as
    corruption — the shared-filesystem retry loop's hook (a transient
    NFS hiccup must not condemn a good bundle)."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != _RESUME_FORMAT:
            return False
        for member, digest in manifest["digests"].items():
            if _sha256(os.path.join(path, member)) != digest:
                return False
        for member in manifest.get("expected_shards", []):
            if member in manifest["digests"]:
                continue
            with open(os.path.join(path, member + ".sha256")) as f:
                if _sha256(os.path.join(path, member)) != f.read().strip():
                    return False
        with open(os.path.join(path, "resume.json")) as f:
            json.load(f)
        return True
    except OSError:
        if raise_io:
            raise
        return False
    except (ValueError, KeyError):
        return False


def latest_valid_bundle(directory: str) -> Optional[str]:
    """Newest bundle whose digests verify; corrupt ones are skipped
    with a loud warning (torn by a crash mid-save, truncated by a full
    disk...) so the fallback is visible, not silent."""
    for _, path in _list_bundles(directory):
        if validate_bundle(path):
            return path
        log.warning("resilience: bundle %s failed digest validation — "
                    "falling back to the previous one", path)
    return None


def retire_bundles(directory: str) -> None:
    """Remove all bundles — called when a run COMPLETES, so a later fit
    with auto_resume on the same dir starts fresh instead of reviving
    the finished run's final state."""
    for _, path in _list_bundles(directory):
        shutil.rmtree(path, ignore_errors=True)


# ======================================================================
# bundle stores
# ======================================================================
class BundleStore:
    """Where resumable bundles live and how survivors discover them.

    The base class is one local directory, this
    process the only writer, discovery = newest digest-valid dir. The
    control plane's phase-2 migration needs more: when a WORKER HOST
    dies, its local disk dies with it, so the surviving host that
    inherits the job must find the bundle somewhere it can reach —
    that is ``SharedFSBundleStore``. ``FaultTolerance`` accepts either
    (``bundle_store=``); ``checkpoint_dir=`` keeps meaning a plain
    local store.

    ``io_retries``/``io_backoff``: transient-I/O posture. Local disks
    failing is fatal (0 retries keeps the historical fail-fast);
    shared filesystems hiccup routinely, so the shared store retries
    ``OSError`` with exponential backoff + jitter before declaring a
    bundle invalid or falling back to the previous one
    (``dl4j_tpu_ft_bundle_io_retries_total`` counts, mirroring the
    transfer-retry policy)."""

    kind = "local"

    def __init__(self, directory, *, io_retries: int = 0,
                 io_backoff: float = 0.05):
        self.directory = os.fspath(directory)
        self.io_retries = int(io_retries)
        self.io_backoff = float(io_backoff)

    # ------------------------------------------------------------ retry
    def _retrying(self, what: str, fn: Callable, *a, **kw):
        attempt = 0
        while True:
            try:
                return fn(*a, **kw)
            except OSError as e:
                if attempt >= self.io_retries:
                    raise
                attempt += 1
                delay = self.io_backoff * (2 ** (attempt - 1)) \
                    * (1.0 + random.random())
                if _telemetry.enabled():
                    _telemetry.MetricsRegistry.get_default().counter(
                        _telemetry.FT_BUNDLE_IO_RETRIES,
                        "transient bundle-store I/O failures retried "
                        "with backoff").inc(op=what)
                log.warning(
                    "resilience: transient bundle-store I/O failure "
                    "during %s (%s: %s) — retry %d/%d in %.2fs",
                    what, type(e).__name__, e, attempt,
                    self.io_retries, delay)
                time.sleep(delay)

    # -------------------------------------------------------------- api
    def write(self, model, resume_meta: Dict[str, Any],
              keep_last: int = 2, trainer=None) -> str:
        return self._retrying(
            "write_bundle", write_bundle, self.directory, model,
            resume_meta, keep_last=keep_last, trainer=trainer)

    def _validate_once(self, path: str) -> bool:
        try:
            return validate_bundle(path, raise_io=True)
        except FileNotFoundError:
            # an ABSENT member is incompleteness (a slower host still
            # publishing, or a torn bundle) — retrying the read won't
            # make it appear; only EIO/ESTALE-class errors are the
            # transient filesystem hiccups the backoff exists for
            return False

    def validate(self, path: str) -> bool:
        try:
            return self._retrying("validate_bundle",
                                  self._validate_once, path)
        except OSError:
            # the retry budget is spent: NOW it reads as corruption and
            # discovery falls back to the previous bundle
            return False

    def latest_valid(self) -> Optional[str]:
        try:
            bundles = self._retrying("list_bundles", _list_bundles,
                                     self.directory)
        except OSError:
            return None
        for _, path in bundles:
            if self.validate(path):
                return path
            log.warning("resilience: bundle %s failed digest "
                        "validation — falling back to the previous "
                        "one", path)
        return None

    def discover(self) -> List[Dict[str, Any]]:
        """Every bundle the store can see, newest first — including
        who wrote it and whether it is complete/valid. The cross-host
        survivor's view: after a worker host dies, any other host
        enumerates the dead host's checkpoints here."""
        out = []
        for it, path in _list_bundles(self.directory):
            host = None
            try:
                with open(os.path.join(path, "manifest.json")) as f:
                    host = json.load(f).get("host")
            except (OSError, ValueError):
                pass
            out.append({"iteration": it, "path": path, "host": host,
                        "complete": _bundle_complete(path),
                        "valid": self.validate(path)})
        return out

    def retire(self) -> None:
        retire_bundles(self.directory)

    def describe(self) -> str:
        return f"{self.kind}:{self.directory}"


class LocalBundleStore(BundleStore):
    """Single-host local-directory store — the explicit spelling of
    ``FaultTolerance(checkpoint_dir=...)``."""


class SharedFSBundleStore(BundleStore):
    """Bundle store on a shared/remote filesystem (NFS, Lustre, a
    FUSE-mounted object bucket): one namespace directory that EVERY
    worker host mounts, so a bundle written by a host that later died
    restores on any survivor.

    Multi-host writes: process 0 publishes the canonical bundle
    (model.zip + resume.json + manifest listing every expected
    per-host shard); other processes attach their
    ``zero_shards_p<i>.npz`` via ``publish_foreign_shard`` (atomic,
    sidecar-digested). Only process 0 prunes, and only around
    COMPLETE bundles — see ``_prune_bundles`` for the race this
    closes. Transient ``OSError`` retries with backoff + jitter are on
    by default (``io_retries=4``)."""

    kind = "shared_fs"

    def __init__(self, root, namespace: str = "default", *,
                 io_retries: int = 4, io_backoff: float = 0.05,
                 publish_wait_s: float = 10.0,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        super().__init__(os.path.join(os.fspath(root), namespace),
                         io_retries=io_retries, io_backoff=io_backoff)
        self.namespace = str(namespace)
        self.publish_wait_s = float(publish_wait_s)
        # injectable identity: tests (and supervisors spawning workers
        # that are not torch.distributed ranks) pin these explicitly
        self._process_index = process_index
        self._process_count = process_count

    def _identity(self) -> Tuple[int, int]:
        if self._process_index is not None:
            return self._process_index, self._process_count or 1
        return _host_identity()

    def write(self, model, resume_meta: Dict[str, Any],
              keep_last: int = 2, trainer=None) -> str:
        pidx, pcnt = self._identity()
        if pidx == 0:
            return self._retrying(
                "write_bundle", write_bundle, self.directory, model,
                resume_meta, keep_last=keep_last, trainer=trainer,
                process_index=pidx, process_count=pcnt)
        # non-zero host: publish only this host's shard into the
        # bundle process 0 names (iteration is globally agreed — every
        # host sits at the same step boundary when a checkpoint fires)
        iteration = int(model.getIterationCount())
        if trainer is None:
            # nothing host-local to contribute
            return os.path.join(self.directory,
                                f"bundle-{iteration:010d}")
        raise _sharded(trainer, "the shared-filesystem shard publication")


# ======================================================================
# object-store bundle store (rename-less commit protocol)
# ======================================================================
class InMemoryObjectStore:
    """Dict-backed object-store client — the in-process test double for
    the ``put/get/list/delete`` protocol ``ObjectStoreBundleStore``
    speaks. A missing key raises ``KeyError`` (deterministic absence),
    never ``OSError`` (transient trouble) — the retry loop must not
    burn its budget waiting for an object that does not exist."""

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, key, data) -> None:
        with self._lock:
            self._blobs[str(key)] = bytes(data)

    def get(self, key) -> bytes:
        with self._lock:
            try:
                return self._blobs[str(key)]
            except KeyError:
                raise KeyError(f"no object at {key}") from None

    def list(self, prefix) -> List[str]:
        p = str(prefix)
        with self._lock:
            return sorted(k for k in self._blobs if k.startswith(p))

    def delete(self, key) -> None:
        with self._lock:
            self._blobs.pop(str(key), None)

    def describe(self) -> str:
        return f"memory({len(self._blobs)} objects)"


class LocalObjectStore:
    """Filesystem-backed object-store client: ``/``-separated keys map
    to files under ``root``. ``put`` is DELIBERATELY a plain
    open/write — no tmp-rename, no fsync — because the class emulates
    bucket semantics, where atomicity comes from the COMMIT PROTOCOL
    above it, not from the storage layer (and where a torn upload
    really does leave a truncated blob under the key). Two instances
    over one root are two hosts sharing a bucket — the cross-host
    discovery substrate for tests and single-machine drills."""

    def __init__(self, root):
        self.root = os.fspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key) -> str:
        return os.path.join(self.root, *str(key).split("/"))

    def put(self, key, data) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(bytes(data))

    def get(self, key) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(f"no object at {key}") from None

    def list(self, prefix) -> List[str]:
        p = str(prefix)
        out = []
        for dirpath, _, files in os.walk(self.root):
            for nm in files:
                rel = os.path.relpath(os.path.join(dirpath, nm),
                                      self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(p):
                    out.append(key)
        return sorted(out)

    def delete(self, key) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def describe(self) -> str:
        return f"file({self.root})"


class ObjectStoreBundleStore(BundleStore):
    """Bundle store over S3/GCS-style object storage — no rename, no
    fsync, no atomic directory publish to lean on, so the atomicity
    the local stores get from ``os.replace`` is rebuilt as a COMMIT
    PROTOCOL:

    - every write attempt uploads its members under a fresh
      write-unique prefix ``<ns>/bundles/<name>/<token>/<member>``;
    - the COMMIT OBJECT ``<ns>/commit/<name>`` — the manifest plus
      the winning token and per-member digests — is written LAST.
      Readers enumerate ONLY the commit namespace, so an uncommitted
      (crashed, torn, still-uploading) prefix is invisible by
      construction;
    - non-zero hosts attach ``zero_shards_p<i>.npz`` under
      ``<ns>/shards/<name>/`` with a ``.sha256`` marker object
      uploaded AFTER the blob — no marker, no shard, exactly the
      sidecar contract of ``publish_foreign_shard``;
    - every download digest-verifies against the commit/marker before
      use: a torn upload (half a blob under the right key — chaos's
      ``store_torn``) is detected and the reader falls back to the
      previous commit, mirroring ``latest_valid_bundle``.

    Restore needs local files (``_restore_bundle`` reads paths), so
    ``latest_valid``/``discover`` MATERIALIZE commits into the local
    cache directory, which doubles as the ``FaultTolerance``
    ``checkpoint_dir`` anchor and as the offline fallback when the
    store is unreachable. ``client`` is anything speaking
    put/get/list/delete (``InMemoryObjectStore``,
    ``LocalObjectStore``, a real SDK adapter); it is automatically
    wrapped by ``chaos.FaultyObjectStore.from_env`` so the
    ``DL4J_TPU_CHAOS_STORE_*`` knobs inject faults without code
    changes. Transient ``OSError`` retries with backoff are on by
    default (``io_retries=4``), counted in
    ``dl4j_tpu_ft_bundle_io_retries_total``."""

    kind = "object_store"

    def __init__(self, client, namespace: str = "default", *,
                 cache_dir=None, io_retries: int = 4,
                 io_backoff: float = 0.05,
                 publish_wait_s: float = 10.0,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        if cache_dir is None:
            cache_dir = tempfile.mkdtemp(
                prefix="dl4j_tpu_ostore_cache.")
        super().__init__(cache_dir, io_retries=io_retries,
                         io_backoff=io_backoff)
        self.client = _chaos.FaultyObjectStore.from_env(client)
        self.namespace = str(namespace)
        self.publish_wait_s = float(publish_wait_s)
        self._process_index = process_index
        self._process_count = process_count

    def _identity(self) -> Tuple[int, int]:
        if self._process_index is not None:
            return self._process_index, self._process_count or 1
        return _host_identity()

    def _key(self, *parts: str) -> str:
        return "/".join((self.namespace,) + parts)

    # ------------------------------------------------------------ write
    def write(self, model, resume_meta: Dict[str, Any],
              keep_last: int = 2, trainer=None) -> str:
        pidx, pcnt = self._identity()
        if pidx != 0:
            return self._write_shard(model, trainer)
        # stage locally first: the cache gets a normal atomic bundle
        # (and local keep_last pruning) for free, and a crash between
        # here and the commit upload still leaves a restorable local
        # checkpoint for a same-host restart
        path = self._retrying(
            "write_bundle", write_bundle, self.directory, model,
            resume_meta, keep_last=keep_last, trainer=trainer,
            process_index=0, process_count=pcnt)
        name = os.path.basename(path)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        token = uuid.uuid4().hex
        members: Dict[str, Any] = {}
        for member, digest in manifest["digests"].items():
            with open(os.path.join(path, member), "rb") as f:
                data = f.read()
            self._retrying(
                "put", self.client.put,
                self._key("bundles", name, token, member), data)
            members[member] = {"sha256": digest, "size": len(data)}
        commit = dict(manifest, prefix=token, members=members)
        self._retrying(
            "commit", self.client.put, self._key("commit", name),
            json.dumps(commit).encode())
        try:
            self._prune_remote(keep_last)
        except OSError as e:
            # hygiene, not correctness: uncommitted garbage is already
            # invisible; stale commits just cost bucket space
            log.warning("resilience: remote bundle pruning failed "
                        "(%s) — will retry at the next checkpoint", e)
        return path

    def _write_shard(self, model, trainer) -> str:
        """Non-zero host: attach this host's shard blob + digest
        marker to the bundle process 0 committed for this step."""
        iteration = int(model.getIterationCount())
        pidx, _ = self._identity()
        member = f"zero_shards_p{pidx}.npz"
        if trainer is None:
            return self._key("commit", f"bundle-{iteration:010d}")
        raise _sharded(trainer, "the object-store shard publication")

    def _await_commit(self, iteration: int) -> str:
        deadline = time.monotonic() + self.publish_wait_s
        while True:
            try:
                for it, name, _ in self._commits():
                    if it == iteration:
                        return name
            except OSError:
                pass            # keep polling until the deadline
            if time.monotonic() > deadline:
                raise OSError(
                    f"no commit for iteration {iteration} was "
                    f"published by process 0 within "
                    f"{self.publish_wait_s}s — cannot attach shard")
            time.sleep(0.05)

    # ------------------------------------------------------- discovery
    def _commits(self) -> List[Tuple[int, str, Dict[str, Any]]]:
        """(iteration, name, commit manifest) for every committed
        bundle, newest first — the ONLY enumeration readers do."""
        out = []
        prefix = self._key("commit") + "/"
        for key in self._retrying("list_commits", self.client.list,
                                  prefix):
            name = key[len(prefix):] if key.startswith(prefix) \
                else key.rsplit("/", 1)[-1]
            m = _BUNDLE_RE.fullmatch(name)
            if not m:
                continue
            try:
                manifest = json.loads(self._retrying(
                    "get_commit", self.client.get, key))
            except (KeyError, ValueError) as e:
                log.warning("resilience: unreadable commit object %s "
                            "(%s) — skipping", key, e)
                continue
            if manifest.get("format") != _RESUME_FORMAT:
                continue
            out.append((int(m.group(1)), name, manifest))
        return sorted(out, key=lambda t: (t[0], t[1]), reverse=True)

    def _materialize(self, name: str,
                     manifest: Dict[str, Any]) -> Optional[str]:
        """Download a committed bundle into the local cache,
        digest-verifying every member against the commit. Returns the
        local path, or None when the bundle is incomplete (a shard
        marker missing) or any object fails verification (torn
        upload) — the caller falls back to the previous commit."""
        token = manifest.get("prefix", "")
        members = manifest.get("members", {})
        digests = manifest.get("digests", {})
        plan = [(m, self._key("bundles", name, token, m),
                 info["sha256"]) for m, info in members.items()]
        foreign = []
        for member in manifest.get("expected_shards", []):
            if member in members or member in digests:
                continue
            marker = self._key("shards", name, member) + ".sha256"
            try:
                want = self._retrying(
                    "get", self.client.get, marker).decode().strip()
            except KeyError:
                log.warning("resilience: bundle %s is incomplete — "
                            "shard marker %s not yet published",
                            name, member)
                return None
            foreign.append((member, self._key("shards", name, member),
                            want))
        local = os.path.join(self.directory, name)
        os.makedirs(local, exist_ok=True)
        for member, key, want in plan + foreign:
            dst = os.path.join(local, member)
            if os.path.exists(dst) and _sha256(dst) == want:
                continue        # warm cache: already verified local
            try:
                data = self._retrying("get", self.client.get, key)
            except KeyError:
                log.warning("resilience: bundle %s is missing object "
                            "%s — treating as incomplete", name, key)
                return None
            if hashlib.sha256(data).hexdigest() != want:
                log.warning("resilience: object %s failed digest "
                            "validation (torn upload?) — falling "
                            "back to the previous bundle", key)
                return None
            tmp = dst + f".{uuid.uuid4().hex[:8]}.tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, dst)
        for member, _, want in foreign:
            side = os.path.join(local, member + ".sha256")
            if not os.path.exists(side):
                with open(side, "w") as f:
                    f.write(want)
        # a local manifest makes the materialized dir indistinguishable
        # from a write_bundle dir: base validate() and _restore_bundle
        # work on it unchanged
        local_manifest = {k: v for k, v in manifest.items()
                          if k not in ("prefix", "members")}
        local_manifest["digests"] = dict(
            digests, **{m: info["sha256"]
                        for m, info in members.items()})
        with open(os.path.join(local, "manifest.json"), "w") as f:
            json.dump(local_manifest, f)
        return local

    def latest_valid(self) -> Optional[str]:
        try:
            commits = self._commits()
        except OSError as e:
            log.warning("resilience: object store unreachable (%s) — "
                        "falling back to the local cache", e)
            return super().latest_valid()
        for _, name, manifest in commits:
            try:
                path = self._materialize(name, manifest)
            except OSError as e:
                log.warning("resilience: object store unreachable "
                            "mid-download (%s) — falling back to the "
                            "local cache", e)
                return super().latest_valid()
            if path is not None and self.validate(path):
                return path
            log.warning("resilience: committed bundle %s did not "
                        "materialize/validate — falling back to the "
                        "previous one", name)
        # a REACHABLE store with no valid commit is authoritative: a
        # staged-but-never-committed local bundle "didn't happen"
        # cluster-wide, and after retire() nothing may resume
        return None

    def discover(self) -> List[Dict[str, Any]]:
        try:
            commits = self._commits()
        except OSError:
            return super().discover()
        out = []
        for it, name, manifest in commits:
            path = self._materialize(name, manifest)
            out.append({
                "iteration": it,
                "path": path if path else self._key("commit", name),
                "host": manifest.get("host"),
                "complete": self._remote_complete(name, manifest),
                "valid": path is not None and self.validate(path),
            })
        return out

    def _remote_complete(self, name: str,
                         manifest: Dict[str, Any]) -> bool:
        """Cheap completeness probe, bucket edition: every expected
        shard is either a committed member or has its marker object
        (no digest pass — mirrors ``_bundle_complete``)."""
        members = manifest.get("members", {})
        digests = manifest.get("digests", {})
        for member in manifest.get("expected_shards", []):
            if member in members or member in digests:
                continue
            try:
                self._retrying(
                    "get", self.client.get,
                    self._key("shards", name, member) + ".sha256")
            except KeyError:
                return False
        return True

    # ------------------------------------------------------- retention
    def _prune_remote(self, keep_last: int) -> None:
        """keep_last in the bucket, same rules as ``_prune_bundles``:
        process 0 only, count only COMPLETE bundles, never delete an
        incomplete bundle at/after the cutoff (a slower host is still
        uploading its shard)."""
        if self._identity()[0] != 0:
            return
        commits = self._commits()
        complete = [(it, nm, mf) for it, nm, mf in commits
                    if self._remote_complete(nm, mf)]
        if not complete:
            return
        kept = complete[:max(keep_last, 1)]
        keep = {nm for _, nm, _ in kept}
        cutoff = kept[-1][0]
        for it, nm, mf in commits:
            if nm in keep:
                continue
            if it >= cutoff and not self._remote_complete(nm, mf):
                continue
            self._delete_remote(nm)

    def _delete_remote(self, name: str) -> None:
        # the commit object goes FIRST — the bundle becomes invisible
        # atomically; the blob sweep after it can tear harmlessly
        self._retrying("delete", self.client.delete,
                       self._key("commit", name))
        for prefix in (self._key("bundles", name) + "/",
                       self._key("shards", name) + "/"):
            for key in self._retrying("list", self.client.list,
                                      prefix):
                self._retrying("delete", self.client.delete, key)

    def retire(self) -> None:
        try:
            for _, name, _ in self._commits():
                self._delete_remote(name)
        except OSError as e:
            log.warning("resilience: could not retire remote bundles "
                        "(%s) — local cache retired anyway", e)
        super().retire()

    def describe(self) -> str:
        inner = getattr(self.client, "describe", None)
        where = inner() if callable(inner) else repr(self.client)
        return (f"{self.kind}:{where}/{self.namespace} "
                f"(cache {self.directory})")


# ======================================================================
# preemption notices
# ======================================================================
class PreemptionNotice:
    """One cluster maintenance announcement: when it arrived, how much
    time the platform granted before the kill, and through which
    channel (``signal`` / ``metadata`` / ``http`` / ``api`` /
    ``chaos_notice``). ``deadline_s=None`` means no enforced deadline
    (an operator drain)."""

    def __init__(self, deadline_s: Optional[float] = None,
                 kind: str = "api"):
        self.wall_t = time.time()
        self._t0 = time.monotonic()
        self.deadline_s = (None if deadline_s is None
                           else float(deadline_s))
        self.kind = str(kind)

    def remaining(self) -> Optional[float]:
        if self.deadline_s is None:
            return None
        return self.deadline_s - (time.monotonic() - self._t0)

    @property
    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "deadline_s": self.deadline_s,
                "remaining_s": self.remaining(), "wall_t": self.wall_t}


class NoticePoller:
    """GCE/Borg-style maintenance-event watcher: a daemon thread polls
    a metadata source and converts the first maintenance announcement
    into ``ft.request_preemption(deadline_s, kind="metadata")`` — the
    job checkpoints and drains BEFORE the platform kill instead of
    recovering after it.

    Sources (either/both; first hit wins, then the poller stops):

    - ``file``: a path whose EXISTENCE is the event (the control
      socket/file-lease spelling a ``WorkerSupervisor`` uses, and the
      chaos drill's fake event). Contents may be a JSON object
      (``{"deadline_s": 30}``), a bare number of seconds, or empty
      (``default_deadline_s`` applies).
    - ``url``: polled with GET — the GCE metadata contract: a body of
      ``NONE`` (or an unreachable endpoint) means no event;
      ``TERMINATE``/``MIGRATE_ON_MAINTENANCE``-style bodies or a JSON
      object mean preempt.

    ``run_fit`` starts one automatically when
    ``DL4J_TPU_PREEMPT_NOTICE_FILE`` / ``DL4J_TPU_PREEMPT_METADATA_URL``
    are set, so any policy-driven fit honors cluster notices with zero
    code changes."""

    def __init__(self, ft: "FaultTolerance", *,
                 file: Optional[str] = None, url: Optional[str] = None,
                 poll_s: float = 0.2,
                 default_deadline_s: float = 30.0):
        if file is None and url is None:
            raise ValueError("NoticePoller needs a file or url source")
        self.ft = ft
        self.file = file
        self.url = url
        self.poll_s = float(poll_s)
        self.default_deadline_s = float(default_deadline_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.delivered = False

    @staticmethod
    def from_env(ft: "FaultTolerance",
                 env=None) -> Optional["NoticePoller"]:
        e = env if env is not None else os.environ
        file = e.get("DL4J_TPU_PREEMPT_NOTICE_FILE")
        url = e.get("DL4J_TPU_PREEMPT_METADATA_URL")
        if not file and not url:
            return None
        return NoticePoller(
            ft, file=file or None, url=url or None,
            poll_s=float(e.get("DL4J_TPU_PREEMPT_POLL_S", "0.2") or 0.2),
            default_deadline_s=float(
                e.get("DL4J_TPU_PREEMPT_DEADLINE_S", "30") or 30))

    # ---------------------------------------------------------- sources
    def _parse_body(self, body: str) -> Optional[float]:
        """deadline_s from a source body; None = default deadline.
        Raises ValueError for a no-event body."""
        body = (body or "").strip()
        if not body:
            return None
        try:
            obj = json.loads(body)
        except ValueError:
            if body.upper().startswith(("TERMINATE", "MIGRATE")):
                return None
            raise
        if isinstance(obj, dict):
            d = obj.get("deadline_s")
            return None if d is None else float(d)
        return float(obj)

    def check_once(self) -> bool:
        """One poll pass; True when a notice was delivered."""
        if self.file and os.path.exists(self.file):
            try:
                with open(self.file) as f:
                    deadline = self._parse_body(f.read())
            except (OSError, ValueError):
                deadline = None
            self._deliver(deadline)
            return True
        if self.url:
            try:
                import urllib.request

                with urllib.request.urlopen(self.url, timeout=2) as r:
                    body = r.read().decode("utf-8", "replace")
            except Exception:
                return False     # unreachable metadata = no event
            if body.strip().upper() in ("", "NONE", "FALSE", "0"):
                return False
            try:
                deadline = self._parse_body(body)
            except ValueError:
                return False
            self._deliver(deadline)
            return True
        return False

    def _deliver(self, deadline_s: Optional[float]) -> None:
        self.delivered = True
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        log.warning("resilience: maintenance notice from %s — "
                    "checkpoint-and-drain within %.1fs",
                    self.file or self.url, deadline_s)
        self.ft.request_preemption(deadline_s=deadline_s,
                                   kind="metadata")

    # ----------------------------------------------------------- thread
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self.check_once():
                    return       # one-shot: the notice is delivered
            except Exception:
                log.exception("resilience: notice poller pass failed")
            self._stop.wait(self.poll_s)

    def start(self) -> "NoticePoller":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="NoticePoller")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(2.0)
            self._thread = None


# ======================================================================
# step watchdog
# ======================================================================
def _dump_stacks() -> str:
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    lines = []
    for ident, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        lines.extend(l.rstrip() for l in traceback.format_stack(frame))
    return "\n".join(lines)


class StepWatchdog:
    """Context manager arming a one-shot deadline around a training
    step. On expiry it does NOT kill the step (a first long step is
    usually a jit compile) — it dumps every thread's stack and a
    telemetry snapshot to the log and bumps the stall counter, which is
    exactly the evidence needed when a step is wedged on a dead host
    transfer or a hung collective.

    Cost: one short-lived daemon Timer thread per armed step (~tens of
    µs to start+cancel). Deadlines worth watching are seconds to
    minutes, so that's noise; a sub-millisecond-step workload that
    somehow wants a watchdog would upgrade to a persistent re-armed
    monitor thread."""

    def __init__(self, deadline: float, context: str = "train_step",
                 step: Optional[int] = None,
                 flight_dir: Optional[str] = None,
                 on_fire=None):
        self.deadline = float(deadline)
        self.context = context
        self.step = step
        self.flight_dir = flight_dir
        #: optional callback(watchdog) invoked on expiry — the control
        #: plane's stall verdict feed (no telemetry polling needed)
        self.on_fire = on_fire
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _fire(self) -> None:
        self.fired = True
        if _telemetry.enabled():
            _telemetry.MetricsRegistry.get_default().counter(
                _telemetry.WATCHDOG_STALLS,
                "training steps that exceeded the watchdog deadline"
            ).inc(context=self.context)
        try:
            snap = json.dumps(_telemetry.snapshot())
        except Exception:
            snap = "<unavailable>"
        log.error(
            "WATCHDOG: %s exceeded its %.1fs deadline — still waiting. "
            "Thread stacks:\n%s\ntelemetry: %s",
            self.context, self.deadline, _dump_stacks(), snap)
        # the black box: everything leading UP to the stall. Dumped on
        # its own short-lived thread — the wedged step can't do it
        # itself, and the TIMER thread must stay prompt (its lifetime
        # is part of the watchdog's contract; the dump fsyncs)
        t = threading.Thread(
            target=_flight.incident, args=("watchdog_stall",),
            kwargs=dict(directory=self.flight_dir,
                        context=self.context, step=self.step,
                        deadline_s=self.deadline),
            name="FT-incident-dump", daemon=True)
        t.start()
        if self.on_fire is not None:
            try:
                self.on_fire(self)
            except Exception:
                log.exception("watchdog on_fire callback failed")

    def __enter__(self) -> "StepWatchdog":
        self._timer = threading.Timer(self.deadline, self._fire)
        self._timer.daemon = True
        self._timer.name = "FT-watchdog"
        self._timer.start()
        return self

    def __exit__(self, *exc) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


# ======================================================================
# the policy
# ======================================================================
class FaultTolerance:
    """Fault-tolerance policy for ``fit(..., fault_tolerance=...)``.

    Knobs (all optional — the defaults are a reasonable production
    posture; ``FaultTolerance()`` with no checkpoint_dir still gives
    the divergence guard + watchdog + transfer retry):

    - ``checkpoint_dir``: where preemption bundles live; also the
      auto-resume discovery root. None disables preemption checkpoints.
    - ``auto_resume``: restore the newest valid bundle before training
      (default True when a checkpoint_dir is set).
    - ``keep_last``: bundles retained (>=2 enables corruption fallback).
    - ``preemption_signals``: signals that trigger checkpoint-and-exit.
    - ``divergence_window``: rolling loss window length (0 = guard off).
    - ``spike_factor`` / ``min_history``: a finite loss is divergent
      when it exceeds ``median + spike_factor * max(|median|, 1e-3)``
      and at least ``min_history`` losses have been seen. NaN/Inf is
      always divergent.
    - ``snapshot_every``: steps between in-memory device snapshots
      (rollback granularity).
    - ``max_rollbacks``: rollback budget per fit before
      ``DivergenceError``.
    - ``transfer_retries`` / ``transfer_backoff``: applied to a
      ``DevicePrefetchIterator`` feeding the loop (no-op otherwise).
    - ``step_deadline``: per-step watchdog deadline in seconds
      (None = watchdog off).
    - ``compile_grace_s``: extra watchdog allowance for the FIRST step
      of each fit, which pays the jit compile (minutes on big models).
      Default 0 keeps the historical behavior — a short deadline fires
      on the compile step, which is harmless when the watchdog only
      dumps diagnostics. The JobScheduler arms a generous grace
      (``TrainJob(compile_grace_s=...)``) because there a stall verdict
      triggers a MIGRATION: without the grace, every fresh attempt's
      compile would read as a stall and the job would migrate forever.
    - ``flight_dir``: where flight-recorder incident dumps land
      (watchdog stall / divergence rollback / preemption — see
      profiler/flight_recorder.py). Defaults to
      ``<checkpoint_dir>/incidents`` when a checkpoint_dir is set,
      else the recorder's own default resolution.
    - ``checkpoint_every``: steps between PERIODIC resumable bundles
      (None = preemption-only, the pre-control-plane behavior).
      Periodic bundles are what make a SIGKILL-equivalent death
      (no grace period, no signal — the host just vanishes)
      recoverable: the newest digest-valid bundle restores and the
      run replays forward bit-identically from there. Requires a
      stateful iterator (``get_state``/``set_state``); stateless
      iterators skip periodic bundles with a one-time warning.
    - ``context``: watchdog/telemetry label for this policy's fits
      (the JobScheduler sets ``job:<id>`` so stall counters are
      per-job attributable).
    - ``on_stall``: optional callback(StepWatchdog) invoked from the
      watchdog's timer thread on deadline expiry — the control plane's
      stall-verdict feed.

    The object is reusable across fits — per-run state lives in a
    private ``_RunState`` created by ``run_fit``.
    """

    def __init__(self,
                 checkpoint_dir: Optional[str] = None,
                 auto_resume: bool = True,
                 keep_last: int = 2,
                 preemption_signals: Sequence[int] = (
                     signal.SIGTERM, signal.SIGINT),
                 divergence_window: int = 16,
                 spike_factor: float = 25.0,
                 min_history: int = 8,
                 snapshot_every: int = 10,
                 max_rollbacks: int = 8,
                 transfer_retries: int = 5,
                 transfer_backoff: float = 0.05,
                 step_deadline: Optional[float] = None,
                 compile_grace_s: float = 0.0,
                 flight_dir: Optional[str] = None,
                 checkpoint_every: Optional[int] = None,
                 context: str = "train_step",
                 on_stall=None,
                 bundle_store: Optional[BundleStore] = None):
        self.bundle_store = bundle_store
        if bundle_store is not None:
            if checkpoint_dir \
                    and os.fspath(checkpoint_dir) != bundle_store.directory:
                # both given: the EXPLICIT store wins — silently
                # writing to a local dir would defeat the exact
                # survivor-discovery the store was configured for
                log.warning(
                    "FaultTolerance: both checkpoint_dir=%s and "
                    "bundle_store=%s were given — the bundle store "
                    "wins; bundles will NOT be written to the "
                    "checkpoint_dir", checkpoint_dir,
                    bundle_store.describe())
            # the store's directory doubles as the checkpoint anchor so
            # every "is checkpointing configured" gate (and the
            # incident-dir default) keeps working unchanged
            checkpoint_dir = bundle_store.directory
        self.checkpoint_dir = checkpoint_dir
        self.auto_resume = auto_resume
        self.keep_last = max(int(keep_last), 1)
        self.preemption_signals = tuple(preemption_signals)
        self.divergence_window = int(divergence_window)
        self.spike_factor = float(spike_factor)
        # the rolling window can never hold more than divergence_window
        # losses, so a min_history above it would silently disable the
        # spike rule — clamp so the configured guard is always live
        self.min_history = max(int(min_history), 1)
        if self.divergence_window > 0:
            self.min_history = min(self.min_history,
                                   self.divergence_window)
        self.snapshot_every = max(int(snapshot_every), 1)
        self.max_rollbacks = int(max_rollbacks)
        self.transfer_retries = int(transfer_retries)
        self.transfer_backoff = float(transfer_backoff)
        self.step_deadline = step_deadline
        self.compile_grace_s = float(compile_grace_s)
        self.flight_dir = flight_dir
        self.checkpoint_every = (int(checkpoint_every)
                                 if checkpoint_every else None)
        self.context = str(context)
        self.on_stall = on_stall
        self._preempt = threading.Event()
        # single-slot holders, not plain attributes: resolve_policy's
        # shallow copy shares the LIST objects (like _preempt), so an
        # inject_fault / preemption notice on the original lands in
        # the copy's running fit
        self._fault_box: List[Optional[BaseException]] = [None]
        self._notice_box: List[Optional[PreemptionNotice]] = [None]
        self._ckpt_count = [0]
        self._warned_stateless = False

    def incident_dir(self) -> Optional[str]:
        """Where this policy's incident dumps go; None defers to the
        flight recorder's default resolution."""
        if self.flight_dir:
            return self.flight_dir
        if self.checkpoint_dir:
            return os.path.join(self.checkpoint_dir, "incidents")
        return None

    # ------------------------------------------------------------ misc
    @property
    def preemption_requested(self) -> bool:
        return self._preempt.is_set()

    @property
    def notice(self) -> Optional[PreemptionNotice]:
        """The live preemption notice (None when preemption was never
        requested, or the last one was consumed by a checkpoint)."""
        return self._notice_box[0]

    @property
    def preemptions_checkpointed(self) -> int:
        """Preemption checkpoints this policy has written — how a
        caller (the worker runner, a drill) tells a drained-by-notice
        exit from a normal completion."""
        return self._ckpt_count[0]

    def store(self) -> Optional[BundleStore]:
        """The bundle store checkpoints go to / resume comes from:
        the explicit ``bundle_store`` when its directory is still the
        policy's checkpoint anchor, else a plain local store over
        ``checkpoint_dir`` (the historical behavior), else None."""
        if self.bundle_store is not None \
                and (not self.checkpoint_dir
                     or self.checkpoint_dir == self.bundle_store.directory):
            return self.bundle_store
        if self.checkpoint_dir:
            return LocalBundleStore(self.checkpoint_dir)
        return None

    def request_preemption(self, deadline_s: Optional[float] = None,
                           kind: str = "api") -> None:
        """Preemption notice: checkpoint ONE resumable bundle at the
        next step boundary, then exit the fit cleanly. Callable from
        any thread (the signal handler, a metadata poller, the
        scheduler, an HTTP handler). ``deadline_s`` is the platform's
        grace window — when notices stack, the EARLIEST absolute
        deadline wins; the checkpoint path records whether the bundle
        landed inside it. A notice whose window is shorter than a
        step cannot be honored in time — the kill lands first and
        recovery degrades to the newest periodic bundle (the
        SIGKILL-equivalent story)."""
        notice = PreemptionNotice(deadline_s, kind)
        prev = self._notice_box[0]
        mine, theirs = notice.remaining(), \
            prev.remaining() if prev is not None else None
        if prev is None or (mine is not None
                            and (theirs is None or mine < theirs)):
            self._notice_box[0] = notice
        _flight.record("preemption_notice", notice_kind=kind,
                       deadline_s=deadline_s, context=self.context)
        self._preempt.set()

    def inject_fault(self, exc: BaseException) -> None:
        """SIGKILL-equivalent fault injection: the fit loop raises
        ``exc`` at its next step boundary WITHOUT writing a checkpoint
        — unlike ``request_preemption``, nothing gets to clean up.
        The JobScheduler's kill-a-worker drill delivers device-loss
        this way (an in-process thread can't be hard-killed); recovery
        is the newest periodic bundle, exactly as after a real host
        death."""
        self._fault_box[0] = exc

    @contextlib.contextmanager
    def _signal_scope(self):
        """Install checkpoint-on-signal handlers for the duration of a
        fit; always restores the previous handlers. Signals can only be
        trapped on the main thread — elsewhere the loop still honors
        ``request_preemption()``, it just can't hook SIGTERM itself.

        The flag is deliberately NOT cleared on entry: a preemption
        notice that arrives before fit() (or during the auto-resume
        restore) must checkpoint at the FIRST step boundary, not be
        silently discarded. The loop clears it after acting on it."""
        if not self.preemption_signals \
                or threading.current_thread() is not threading.main_thread():
            yield
            return

        def _handler(signum, frame):
            if self._preempt.is_set():
                # second signal: the operator (or the platform's grace-
                # period enforcer) wants out NOW
                raise KeyboardInterrupt(
                    f"signal {signum} received twice during training")
            self.request_preemption(kind="signal")
            log.warning(
                "resilience: signal %s received — writing a resumable "
                "checkpoint at the next step boundary, then exiting",
                signum)

        prev = {}
        try:
            for s in self.preemption_signals:
                prev[s] = signal.signal(s, _handler)
        except (ValueError, OSError):
            pass   # restricted environment: proceed unhooked
        try:
            yield
        finally:
            for s, h in prev.items():
                if h is not None:   # None = handler installed at C
                    signal.signal(s, h)   # level; not restorable from
                #                           Python (signal.signal(s,
                #                           None) raises TypeError)

    def _watchdog(self, step: Optional[int] = None):
        if self.step_deadline is None:
            return contextlib.nullcontext()
        deadline = self.step_deadline
        if step == 0 and self.compile_grace_s > 0:
            # this run's first step pays the jit compile; a deadline
            # tuned for warm steps would misfire every (re)start
            deadline += self.compile_grace_s
        return StepWatchdog(deadline, context=self.context,
                            step=step, flight_dir=self.incident_dir(),
                            on_fire=self.on_stall)


def resolve_policy(fault_tolerance: Optional[FaultTolerance],
                   auto_resume) -> Optional[FaultTolerance]:
    """Merge the two fit kwargs into one policy. ``auto_resume=dir`` is
    the one-argument spelling of 'checkpoint here, resume from here'."""
    if fault_tolerance is None and auto_resume is None:
        return None
    ft = fault_tolerance if fault_tolerance is not None else FaultTolerance()
    if auto_resume:
        if fault_tolerance is not None:
            # never mutate the caller's policy object: it is documented
            # as reusable across fits, and a later fit passing only
            # fault_tolerance= must not inherit this call's resume dir.
            # A SHALLOW copy deliberately shares the _preempt Event so
            # ft.request_preemption() on the original still lands.
            import copy

            ft = copy.copy(fault_tolerance)
        if isinstance(auto_resume, (str, os.PathLike)):
            ft.checkpoint_dir = os.fspath(auto_resume)
        ft.auto_resume = True
    return ft


# ======================================================================
# the networks' seam
# ======================================================================
def _clone_tree(tree):
    """A copy of a tree of tensors (dicts, lists, tuples; other leaves
    pass through), every tensor cloned on its device."""
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_clone_tree(v) for v in tree]
        return tuple(out) if isinstance(tree, tuple) else out
    return tree


class _FitAdapter:
    """Step, snapshot and restore over the two fit front-ends."""

    def __init__(self, model, trainer=None):
        if trainer is not None:
            raise _sharded(trainer, "fit(fault_tolerance=...)")
        self.model = model
        self.trainer = None
        self.is_graph = hasattr(model, "params_map")

    def step(self, batch) -> None:
        from deeplearning4j_tpu_torch.datasets.multi_dataset import (
            MultiDataSet)

        if self.is_graph:
            if isinstance(batch, MultiDataSet):
                self.model._fit_batch(batch.features, batch.labels,
                                      batch.labels_mask_arrays or None,
                                      batch.features_mask_arrays or None)
            else:
                self.model._fit_batch([batch.features], [batch.labels],
                                      [batch.labels_mask],
                                      [batch.features_mask])
        else:
            self.model._fit_batch(batch.features, batch.labels,
                                  batch.labels_mask, batch.features_mask)

    def end_epoch(self) -> None:
        """The epoch count and the listeners' ``onEpochEnd``, as the
        networks' own loop books an epoch."""
        m = self.model
        m._epoch += 1
        for l in m._listeners:
            if hasattr(l, "onEpochEnd"):
                l.onEpochEnd(m)

    def _trees(self):
        m = self.model
        return (m.params_map, m.states_map) if self.is_graph \
            else (m.params_list, m.states_list)

    def snapshot(self) -> Dict[str, Any]:
        """The whole training state, cloned on the card: parameters,
        layer state, updater state, loss-scale state, counters, the
        generator's state and the score."""
        m = self.model
        params, states = self._trees()
        gen = getattr(m, "_generator", None)
        snap: Dict[str, Any] = {
            "iteration": m._iteration,
            "epoch": m._epoch,
            "rng": gen.get_state() if gen is not None else None,
            "score": m._score,
            "params": _clone_tree(params),
            "states": _clone_tree(states),
            "opt": _clone_tree(m.opt_states),
        }
        if getattr(m, "_loss_scale_state", None) is not None:
            snap["ls"] = _clone_tree(m._loss_scale_state)
            snap["ls_seen"] = m._ls_seen
        return snap

    def restore(self, snap: Dict[str, Any]) -> None:
        """Install a snapshot as fresh clones (the snapshot itself stays
        valid for a second rollback)."""
        m = self.model
        if self.is_graph:
            m.params_map = _clone_tree(snap["params"])
            m.states_map = _clone_tree(snap["states"])
        else:
            m.params_list = _clone_tree(snap["params"])
            m.states_list = _clone_tree(snap["states"])
        m.opt_states = _clone_tree(snap["opt"])
        m._iteration = snap["iteration"]
        m._epoch = snap["epoch"]
        if snap["rng"] is not None:
            m._generator.set_state(snap["rng"])
        m._score = snap["score"]
        if "ls" in snap:
            m._loss_scale_state = _clone_tree(snap["ls"])
            m._ls_seen = snap["ls_seen"]


class _RunState:
    def __init__(self, ft: FaultTolerance, adapter: "_FitAdapter"):
        self.steps_done = 0        # monotonic, survives rollbacks
        self.rollbacks = 0
        self.snapshot: Optional[Dict[str, Any]] = None
        self.since_snapshot = 0
        self.window: deque = deque(maxlen=max(ft.divergence_window, 1))
        #: layer label of the current non-finite event (HealthMonitor
        #: provenance): it rides the rollback telemetry, then clears
        self.nonfinite_layer: Optional[str] = None
        # mixed_float16: the skipped-step count at fit entry, so the guard
        # tells an overflow the loss scaling handled from divergence
        self.ls_skipped_seen = (_ls_skipped(adapter.model)
                                if ft.divergence_window > 0 else 0)


def _ls_skipped(model) -> int:
    """The loss-scale state's skipped-step count (a read-back; 0 without
    loss scaling)."""
    ls = getattr(model, "_loss_scale_state", None)
    if ls is None:
        return 0
    return int(ls["skipped_steps"])


# ======================================================================
# data plumbing
# ======================================================================
def _as_iterator(data, labels, adapter: _FitAdapter):
    """Every fit input as an iterator: ``(iterator, was_iterator)``. The
    epoch count and the listeners' ``onEpochEnd`` advance for iterator
    inputs only, as in the networks' own loop."""
    from deeplearning4j_tpu_torch.datasets import (
        DataSet, DataSetIterator, ListDataSetIterator,
        ListMultiDataSetIterator, MultiDataSet, MultiDataSetIterator)

    if isinstance(data, (DataSetIterator, MultiDataSetIterator)):
        return data, True
    if isinstance(data, DataSet):
        return ListDataSetIterator([data]), False
    if isinstance(data, MultiDataSet):
        return ListMultiDataSetIterator([data]), False
    if labels is None:
        raise ValueError("fit(x, y) requires labels")
    if adapter.is_graph:
        xs = list(data) if isinstance(data, (list, tuple)) else [data]
        ys = list(labels) if isinstance(labels, (list, tuple)) else [labels]
        return ListMultiDataSetIterator([MultiDataSet(xs, ys)]), False
    return ListDataSetIterator([DataSet(data, labels)]), False


def _try_get_state(it) -> Optional[Dict[str, Any]]:
    try:
        return it.get_state()
    except Exception:
        return None


def _try_set_state(it, state) -> bool:
    try:
        it.set_state(state)
        return True
    except Exception as e:
        log.warning("resilience: iterator %s could not restore mid-epoch "
                    "position (%s) — restarting the interrupted epoch "
                    "from its first batch", type(it).__name__, e)
        return False


# ======================================================================
# bundle <-> live model
# ======================================================================
def _rng_state(model) -> Optional[Dict[str, Any]]:
    """The model's ``torch.Generator`` state for ``resume.json`` (its
    bytes and its device), or None without a generator."""
    gen = getattr(model, "_generator", None)
    if gen is None:
        return None
    return {"state": [int(v) for v in gen.get_state().tolist()],
            "device": str(gen.device)}


def _resume_meta(adapter: _FitAdapter, ist, remaining: int, mid: bool,
                 **extra) -> Dict[str, Any]:
    return dict({"torch_rng": _rng_state(adapter.model),
                 "iterator_state": ist,
                 "epochs_remaining": max(remaining, 0),
                 "mid_epoch": mid,
                 "wall_time": time.time()}, **extra)


def _write_preemption_checkpoint(ft: FaultTolerance, adapter: _FitAdapter,
                                 it, epoch_idx: int, total_epochs: int,
                                 was_iterator: bool) -> None:
    ist = _try_get_state(it)   # non-blocking: reads recorded position
    if ist is not None:
        # no hasNext() probe here: on a wedged or retrying transfer
        # pipeline it can block past the platform's grace period. A
        # restored position with nothing left completes an empty first
        # epoch at resume time, whose bookkeeping runs there.
        remaining = total_epochs - epoch_idx
        mid = True
    else:
        # stateless iterator: a (possibly blocking) hasNext is the only
        # way to tell a finished epoch from an interrupted one
        try:
            has_more = bool(it.hasNext())
        except Exception:
            has_more = False
        if not has_more:
            if was_iterator:
                adapter.end_epoch()   # the epoch completed: book it
            remaining = total_epochs - epoch_idx - 1
        else:
            remaining = total_epochs - epoch_idx   # restart this epoch
            log.warning(
                "resilience: %s does not support state capture — the "
                "resumed run will RESTART the interrupted epoch from "
                "its first batch (batches already trained this epoch "
                "will be trained again); implement get_state/set_state "
                "for exact mid-epoch resume", type(it).__name__)
        mid = False
    store = ft.store()
    if store is None:
        log.warning("resilience: preemption requested but no "
                    "checkpoint_dir/bundle_store configured — exiting "
                    "WITHOUT a resumable checkpoint")
        return
    meta = _resume_meta(adapter, ist, remaining, mid)
    path = store.write(adapter.model, meta, keep_last=ft.keep_last)
    ft._ckpt_count[0] += 1
    if _telemetry.enabled():
        _telemetry.MetricsRegistry.get_default().counter(
            _telemetry.FT_PREEMPTION_CHECKPOINTS,
            "resumable bundles written in response to a preemption "
            "signal").inc()
    notice = ft.notice
    margin = notice.remaining() if notice is not None else None
    if notice is not None and notice.expired:
        log.warning(
            "resilience: preemption checkpoint landed %.2fs AFTER the "
            "%.1fs notice deadline — the platform kill may have "
            "preceded it; periodic bundles are the recovery floor",
            -margin, notice.deadline_s)
    # the bundle restores the run, the flight dump explains the exit:
    # written after the bundle, so a kill mid-dump still leaves a
    # resumable job
    _flight.incident("preemption_checkpoint",
                     directory=ft.incident_dir(),
                     iteration=adapter.model.getIterationCount(),
                     bundle=path,
                     epochs_remaining=meta["epochs_remaining"],
                     mid_epoch=mid,
                     notice_kind=(notice.kind if notice else None),
                     deadline_margin_s=margin,
                     deadline_missed=bool(notice and notice.expired))
    log.warning("resilience: preemption checkpoint written to %s "
                "(iteration %d, %d epoch(s) remaining%s) — exiting "
                "cleanly", path, adapter.model.getIterationCount(),
                meta["epochs_remaining"],
                ", mid-epoch" if mid else "")


def _write_periodic_checkpoint(ft: FaultTolerance, adapter: _FitAdapter,
                               it, epoch_idx: int, total_epochs: int
                               ) -> None:
    """A resumable bundle every ``checkpoint_every`` steps, written in
    stride (the fit goes on): the recovery floor for deaths with no grace
    period. Needs an iterator with ``get_state``."""
    store = ft.store()
    if store is None:
        return
    ist = _try_get_state(it)
    if ist is None:
        if not ft._warned_stateless:
            ft._warned_stateless = True
            log.warning(
                "resilience: checkpoint_every=%d requested but %s has "
                "no get_state/set_state — periodic checkpoints are "
                "SKIPPED (preemption checkpoints still work; implement "
                "iterator state for kill-safe periodic bundles)",
                ft.checkpoint_every, type(it).__name__)
        return
    meta = _resume_meta(adapter, ist, total_epochs - epoch_idx, True,
                        periodic=True)
    path = store.write(adapter.model, meta, keep_last=ft.keep_last)
    if _telemetry.enabled():
        _telemetry.MetricsRegistry.get_default().counter(
            _telemetry.FT_PERIODIC_CHECKPOINTS,
            "periodic resumable bundles written every "
            "checkpoint_every steps").inc()
    _flight.record("periodic_checkpoint",
                   iteration=adapter.model.getIterationCount(),
                   bundle=path)


def _restore_rng(model, resume: Dict[str, Any]) -> None:
    """The generator's state from ``resume.json``. A JAX package's bundle
    carries a JAX key (``rng``) that no torch generator can take: it is
    ignored with a note (the two packages' random draws never matched)."""
    saved = resume.get("torch_rng")
    gen = getattr(model, "_generator", None)
    if saved is not None and gen is not None:
        state = torch.tensor(saved["state"], dtype=torch.uint8)
        if str(gen.device) == saved.get("device", str(gen.device)):
            gen.set_state(state)
        else:
            log.warning("resilience: the bundle's generator state is of "
                        "device %s, the model's generator of %s: the "
                        "dropout draws restart from the model's own seed",
                        saved.get("device"), gen.device)
    elif "rng" in resume:
        log.info("resilience: the bundle carries a JAX PRNG key, which a "
                 "torch.Generator cannot take: the model keeps its own "
                 "generator state")


def _restore_bundle(adapter: _FitAdapter, path: str) -> Dict[str, Any]:
    from deeplearning4j_tpu_torch.util.model_serializer import (
        ModelSerializer)

    with open(os.path.join(path, "resume.json")) as f:
        resume = json.load(f)
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            saved_mesh = json.load(f).get("mesh")
    except (OSError, ValueError):
        saved_mesh = None
    if saved_mesh:
        log.warning("resilience: the bundle was saved on a %s-replica "
                    "mesh; its canonical trees restore onto this single "
                    "device", saved_mesh.get("data"))
    ModelSerializer.loadInto(adapter.model, os.path.join(path, "model.zip"))
    _restore_rng(adapter.model, resume)
    if _telemetry.enabled():
        _telemetry.MetricsRegistry.get_default().counter(
            _telemetry.FT_AUTO_RESUMES,
            "training runs resumed from a preemption bundle").inc()
    _flight.record("auto_resume", bundle=path,
                   iteration=adapter.model.getIterationCount(),
                   epochs_remaining=resume.get("epochs_remaining", 0))
    log.warning("resilience: auto-resumed from %s (iteration %d, epoch "
                "%d, %d epoch(s) remaining%s)", path,
                adapter.model.getIterationCount(),
                adapter.model.getEpochCount(),
                resume.get("epochs_remaining", 0),
                ", mid-epoch" if resume.get("mid_epoch") else "")
    return resume


# ======================================================================
# guarded step helpers
# ======================================================================
def _maybe_snapshot(ft: FaultTolerance, adapter: _FitAdapter,
                    st: _RunState) -> None:
    if ft.divergence_window <= 0:
        return
    if st.snapshot is None or st.since_snapshot >= ft.snapshot_every:
        st.snapshot = adapter.snapshot()
        st.since_snapshot = 0


def _peek_loss_scale(model) -> Optional[float]:
    """Live loss-scale gauge value (already synced per step by the
    precision engine's telemetry mirror) — a host read, never a device
    sync. None when the model has no loss scaling. With several models
    loss-scaling in one process the gauge carries one label set per
    site and this returns the last-registered one — per-model
    attribution would need the site label threaded through the guard."""
    if getattr(model, "_loss_scale_state", None) is None:
        return None
    m = _telemetry.MetricsRegistry.get_default().peek(
        _telemetry.LOSS_SCALE)
    if m is None:
        return None
    vals = list(m.values().values())
    return vals[-1] if vals else None


def _check_divergence(ft: FaultTolerance, adapter: _FitAdapter,
                      st: _RunState) -> bool:
    """Post-step loss inspection. Returns True when the step was rolled
    back (the offending batch is skipped by simply not retrying it)."""
    if ft.divergence_window <= 0:
        return False
    loss = float(adapter.model._score)   # the guard's per-step read-back
    # the guard pays the loss sync anyway — give the black box the
    # per-step loss (+ live loss scale) for free. Enabled-check HERE:
    # the kwargs (registry peek, iteration read) must not be evaluated
    # on a disabled recorder's behalf
    if _flight.get_default().enabled:
        _flight.record("train_loss", step=st.steps_done,
                       iteration=adapter.model.getIterationCount(),
                       loss=loss,
                       loss_scale=_peek_loss_scale(adapter.model))
    bad = not np.isfinite(loss)
    why = "non-finite loss"
    if bad:
        # NaN provenance: a HealthMonitor on the model knows WHICH
        # layer went non-finite this step (profiler/model_health.py) —
        # carry the label on the rollback event instead of making the
        # operator rerun with panic modes to find it
        hm = getattr(adapter.model, "_health", None)
        if hm is not None:
            try:
                layer = hm.nonfinite_label()
            except Exception:
                layer = None
            if layer is not None:
                why = f"non-finite loss (first non-finite layer: {layer})"
                st.nonfinite_layer = layer
        skipped = _ls_skipped(adapter.model)
        if skipped > st.ls_skipped_seen:
            # mixed_float16 handled overflow: the loss-scale engine
            # already skipped this step (params/opt-state held) and
            # halved the scale — that is the precision engine working,
            # not divergence. Rolling back here would reinstate the
            # PRE-halving scale and discard good committed steps.
            st.ls_skipped_seen = skipped
            st.since_snapshot += 1
            return False
    if not bad and len(st.window) >= ft.min_history:
        med = statistics.median(st.window)
        if (loss - med) > ft.spike_factor * max(abs(med), 1e-3):
            bad = True
            why = (f"loss spike {loss:.6g} vs rolling median {med:.6g} "
                   f"(factor {ft.spike_factor:g})")
    if not bad:
        st.window.append(loss)
        st.since_snapshot += 1
        return False
    if st.rollbacks >= ft.max_rollbacks:
        # budget exhausted: still restore the last good snapshot (a
        # caller catching DivergenceError to salvage the run must not
        # be handed diverged/NaN params), but don't count a rollback
        # that is really an abort
        bad_iter = adapter.model.getIterationCount()
        _flight.incident("divergence_abort",
                         directory=ft.incident_dir(),
                         iteration=bad_iter, why=why,
                         nonfinite_layer=st.nonfinite_layer,
                         rollbacks=st.rollbacks)
        adapter.restore(st.snapshot)
        raise DivergenceError(
            f"divergence guard exhausted its rollback budget "
            f"({ft.max_rollbacks}): {why} at iteration {bad_iter} — "
            "the run is not recovering (check the data pipeline and "
            "learning rate); model restored to the last snapshot "
            f"(iteration {st.snapshot['iteration']})")
    st.rollbacks += 1
    if _telemetry.enabled():
        reg = _telemetry.MetricsRegistry.get_default()
        labels = ({"nonfinite_layer": st.nonfinite_layer}
                  if st.nonfinite_layer else {})
        reg.counter(_telemetry.FT_ROLLBACKS,
                    "divergence-guard rollbacks to the in-memory "
                    "snapshot").inc(**labels)
        reg.counter(_telemetry.FT_SKIPPED_BATCHES,
                    "batches skipped after a divergence rollback").inc()
    layer = st.nonfinite_layer
    st.nonfinite_layer = None   # provenance is per-event, not sticky
    discarded = adapter.model.getIterationCount() - 1 \
        - st.snapshot["iteration"]
    log.warning("resilience: %s at iteration %d — rolling back to the "
                "snapshot at iteration %d and skipping the batch "
                "(rollback %d/%d; %d committed step(s) since the "
                "snapshot are discarded and their batches not "
                "replayed — lower snapshot_every for finer-grained "
                "rollback)", why, adapter.model.getIterationCount(),
                st.snapshot["iteration"], st.rollbacks, ft.max_rollbacks,
                max(discarded, 0))
    # post-mortem artifact: the black box holds the steps INTO the
    # divergence (losses, health provenance, the offending step last)
    _flight.incident("divergence_rollback", directory=ft.incident_dir(),
                     iteration=adapter.model.getIterationCount(),
                     rollback_to=st.snapshot["iteration"], why=why,
                     nonfinite_layer=layer, rollback=st.rollbacks)
    adapter.restore(st.snapshot)
    st.since_snapshot = 0
    # the restore rewound the loss-scale engine's counters with the
    # rest of the state — re-baseline so the next handled overflow
    # still reads as a fresh increment
    st.ls_skipped_seen = _ls_skipped(adapter.model)
    return True


# ======================================================================
# the guarded fit loop
# ======================================================================
def run_fit(model, fault_tolerance: Optional[FaultTolerance], data,
            labels=None, epochs: int = 1, auto_resume=None, trainer=None):
    """The guarded fit loop that MultiLayerNetwork and ComputationGraph
    ``fit`` enter only when a policy was requested; their own loop stays
    as it is otherwise."""
    ft = resolve_policy(fault_tolerance, auto_resume)
    if ft is None:
        raise ValueError("run_fit requires a FaultTolerance policy or "
                         "an auto_resume directory")
    # black-box coverage: a crash that escapes every guard still
    # leaves an incident dump behind
    _flight.install_excepthook()
    adapter = _FitAdapter(model, trainer)
    it, was_iterator = _as_iterator(data, labels, adapter)
    try:
        resettable = bool(it.resetSupported())
    except Exception:
        resettable = True
    if int(epochs) > 1 and not resettable:
        raise ValueError(
            "epochs > 1 requires a resettable iterator "
            "(reference behavior)")
    prev_retry = _configure_prefetch_retry(ft, it)
    # cluster-notice wiring (metadata-poll stub): a maintenance event
    # announced through the env-configured source preempts this fit
    poller = NoticePoller.from_env(ft)
    if poller is not None:
        poller.start()

    resumed = None
    store = ft.store()
    if ft.auto_resume and store is not None:
        bundle = store.latest_valid()
        if bundle is not None:
            resumed = _restore_bundle(adapter, bundle)

    total = int(epochs)
    skip_reset_first = False
    if resumed is not None:
        total = int(resumed.get("epochs_remaining", epochs))
        ist = resumed.get("iterator_state")
        if ist is not None:
            # mid-epoch: continue in place (no reset) on the next
            # batch. Epoch boundary: restore anyway — the epoch-opening
            # reset() below then advances the iterator's internal epoch
            # counter, keeping shuffle order identical to a run that
            # was never interrupted
            ok = _try_set_state(it, ist)
            skip_reset_first = ok and bool(resumed.get("mid_epoch"))
        elif total > 0:
            log.warning(
                "resilience: the bundle carries no iterator position "
                "(the interrupted run's iterator had no state support) "
                "— restarting the interrupted epoch from its first "
                "batch")

    # _last_etl_ms as the networks' own loop keeps it: the last wait of an
    # iterator input, None for arrays and single batches
    track_etl = was_iterator
    if not was_iterator:
        model._last_etl_ms = None

    st = _RunState(ft, adapter)
    try:
        with ft._signal_scope():
            for e in range(total):
                # mirror MultiDataSetIterator.__iter__: a one-epoch fit
                # over a non-resettable stream consumes it in place
                if not (skip_reset_first and e == 0) and resettable:
                    it.reset()
                if _run_epoch(ft, adapter, it, st, e, total,
                              was_iterator, track_etl):
                    return model   # preempted: checkpointed clean exit
                if was_iterator:
                    adapter.end_epoch()
    finally:
        if poller is not None:
            poller.stop()
        if prev_retry is not None:
            # the retry posture belongs to THIS policy-driven fit: a
            # later plain fit() on the same iterator must get the
            # fail-fast default back
            it.configure_retries(*prev_retry)
    if ft.auto_resume and store is not None:
        # the run finished: retire its bundles so the next fit on this
        # directory starts fresh instead of reviving a completed run
        store.retire()
    return model


def _configure_prefetch_retry(ft: FaultTolerance, it):
    """Apply the policy's transfer-retry posture to a wrapping
    DevicePrefetchIterator. Returns the iterator's previous
    (retries, backoff, quarantine) for restoration at fit exit, or
    None when nothing was changed."""
    from deeplearning4j_tpu_torch.datasets.device_prefetch import (
        DevicePrefetchIterator)

    if isinstance(it, DevicePrefetchIterator) and ft.transfer_retries > 0 \
            and it._transfer_retries == 0 and not it._quarantine:
        # the user didn't configure their own retry posture — apply the
        # policy's (retry with backoff, then quarantine instead of die)
        prev = (it._transfer_retries, it._transfer_backoff,
                it._quarantine)
        it.configure_retries(ft.transfer_retries,
                             backoff=ft.transfer_backoff,
                             quarantine=True)
        return prev
    return None


def _run_epoch(ft: FaultTolerance, adapter: _FitAdapter, it,
               st: _RunState, epoch_idx: int, total_epochs: int,
               was_iterator: bool = True, track_etl: bool = False) -> bool:
    """One epoch under the guards. Returns True on preemption exit."""
    monkey = _chaos.active()
    while True:
        # the watchdog spans the whole fetch->step->guard cycle, not
        # just the step dispatch: the step itself is ASYNC (a hung
        # collective or wedged transfer surfaces at the next blocking
        # point — the iterator's queue get or the divergence guard's
        # loss sync), so arming only around adapter.step would never
        # fire for exactly the stalls the watchdog exists to diagnose
        with ft._watchdog(step=st.steps_done):
            t0 = time.perf_counter()
            if not it.hasNext():
                return False
            batch = it.next()
            _telemetry.record_phase("etl_wait", t0)
            if track_etl:
                # as the networks' own loop: the wait of the last next()
                adapter.model._last_etl_ms = \
                    (time.perf_counter() - t0) * 1e3
            if monkey is not None:
                batch = monkey.corrupt_batch(batch, st.steps_done)
            _maybe_snapshot(ft, adapter, st)
            adapter.step(batch)
            st.steps_done += 1
            if monkey is not None:
                # inside the watchdog scope on purpose: the injected
                # hang must trip the deadline like a real wedged step
                monkey.maybe_hang(st.steps_done)
            _check_divergence(ft, adapter, st)
        if monkey is not None:
            monkey.maybe_kill(st.steps_done)   # raises: no checkpoint
            monkey.maybe_preempt(st.steps_done, ft=ft)
        fault = ft._fault_box[0]
        if fault is not None:
            # SIGKILL-equivalent (inject_fault): die with NO
            # checkpoint — recovery is the newest periodic bundle
            ft._fault_box[0] = None
            raise fault
        if ft.preemption_requested:
            _write_preemption_checkpoint(ft, adapter, it, epoch_idx,
                                         total_epochs, was_iterator)
            # consumed: the next fit on this (reusable) policy object
            # must not re-preempt off a flag (or notice) already
            # acted on
            ft._preempt.clear()
            ft._notice_box[0] = None
            return True
        if ft.checkpoint_every \
                and st.steps_done % ft.checkpoint_every == 0:
            _write_periodic_checkpoint(ft, adapter, it, epoch_idx,
                                       total_epochs)


__all__ = ["FaultTolerance", "DivergenceError", "StepWatchdog",
           "run_fit", "resolve_policy", "write_bundle",
           "latest_valid_bundle", "validate_bundle", "retire_bundles",
           "BundleStore", "LocalBundleStore", "SharedFSBundleStore",
           "ObjectStoreBundleStore", "InMemoryObjectStore",
           "LocalObjectStore", "PreemptionNotice", "NoticePoller",
           "publish_foreign_shard"]
