"""Device-side input pipeline: counterpart of
``deeplearning4j_tpu/datasets/device_prefetch.py`` (host ETL on a
background thread, host-to-device copies kept ``depth`` batches ahead of
the step, and shape stabilisation).

- ``DevicePrefetchIterator`` wraps a ``DataSetIterator`` (or a
  ``MultiDataSetIterator``: the constructor returns the Multi variant).
  Host ETL runs on an ``AsyncDataSetIterator``; a transfer thread copies
  each batch to the device. On the card a batch is staged in one of
  ``depth + 1`` page-locked buffers, reused round the ring, copied with
  ``non_blocking=True`` on a side stream, and cast there to ``dtype``
  (features only): the copy moves the source's bytes (uint8 pixels are a
  quarter of f32's), and the cast gives the values the JAX package's
  host cast gives. An event recorded after each batch's copies orders
  the consumer's stream after them (``wait_event``), ``record_stream``
  keeps the caching allocator from reusing the batch's memory too early,
  and a staging buffer is refilled only after its last copy's event has
  completed. ``depth=0`` does the same on the consumer's thread, no
  threads at all. On the CPU a batch becomes CPU tensors.
- ``BatchShapePolicy`` (``exact``, ``pad_last``, ``bucket``) pads on the
  host. Padded rows get a zero labels mask and real rows the weight
  padded_N / real_N, which keeps the loss of the unpadded batch
  (``loss.compute_loss`` divides by the padded N). Time padding keeps
  per-timestep sum-reduced losses exact and scales mean-reduced ones by
  real_T / bucket_T; layers with batch statistics (batch norm in
  training) see the padded rows.

The JAX module's telemetry (its docstring, ``:41-52``) is plain
attributes here, read by ``chip_smoke.py``: ``queue_depth`` (batches
queued ahead of the consumer when it last took one),
``transfer_overlap_ms_total`` / ``transfer_overlap_batches`` (time from a
batch's copy issue to its consumption), ``padded_examples_total``,
``bucket_hits_total`` and ``bucket_misses_total`` (the policy's),
``stage_ms_total`` (host time copying batches into the staging buffers),
and from CUDA events :meth:`DevicePrefetchIterator.copy_ms` (each recent
batch's copies on the card) and :meth:`~DevicePrefetchIterator.ready_ms`
(to the end of its casts).

Not ported: sharding over a mesh (``mesh=``, A8) and the transient
transfer policy (``transfer_retries``, ``quarantine``), which belongs to
``util/resilience.py`` (A9).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import not_ported
from deeplearning4j_tpu_torch.datasets.dataset import DataSet, to_numpy
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator
from deeplearning4j_tpu_torch.datasets.multi_dataset import (
    MultiDataSet, MultiDataSetIterator)
from deeplearning4j_tpu_torch.datasets.record_reader_iterator import (
    AsyncDataSetIterator)
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.params import (numpy_to_tensor,
                                             numpy_to_tensor_narrowed)

#: recent batches whose copy events :meth:`DevicePrefetchIterator.copy_ms`
#: reads
COPY_EVENTS_KEPT = 256


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _norm_mask(m: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """Drop a trailing singleton channel: [N,T,1] -> [N,T]."""
    if m is not None and m.ndim >= 2 and m.shape[-1] == 1:
        return m[..., 0]
    return m


def _pad_axis(a: np.ndarray, axis: int, count: int,
              value: float = 0.0) -> np.ndarray:
    if count <= 0:
        return a
    shape = list(a.shape)
    shape[axis] = count
    return np.concatenate([a, np.full(shape, value, a.dtype)], axis)


class BatchShapePolicy:
    """Shape stabilisation applied by the prefetcher, on the host.

    - ``exact``: batches pass untouched.
    - ``pad_last``: the last partial minibatch padded to ``batch_size``
      with zero rows, masked out of the loss.
    - ``bucket``: ``pad_last``, and [N,T,F] sequences padded to
      power-of-two lengths (at least ``min_seq_bucket``) or to the
      smallest of ``seq_buckets``, with the features mask extended and
      the labels mask keeping the loss.

    ``pad_last`` and ``bucket`` always attach a labels mask (scaled, on
    full batches too), so every batch has the same arrays. The counters
    ``padded_examples_total``, ``bucket_hits_total`` (a batch of a shape
    seen before) and ``bucket_misses_total`` (a new shape) count what
    the policy did.
    """

    MODES = ("exact", "pad_last", "bucket")

    def __init__(self, mode: str = "pad_last",
                 batch_size: Optional[int] = None,
                 min_seq_bucket: int = 8,
                 seq_buckets: Optional[Sequence[int]] = None):
        if mode not in self.MODES:
            raise ValueError(f"unknown BatchShapePolicy mode {mode!r}: "
                             f"expected one of {self.MODES}")
        self.mode = mode
        self.batch_size = int(batch_size) if batch_size else None
        self.min_seq_bucket = int(min_seq_bucket)
        self.seq_buckets = (sorted(int(b) for b in seq_buckets)
                            if seq_buckets else None)
        self._seen: set = set()
        self.padded_examples_total = 0
        self.bucket_hits_total = 0
        self.bucket_misses_total = 0

    def bucket_t(self, t: int) -> int:
        """The bucketed length of a raw length ``t``: the smallest
        explicit bucket >= t, or the next power of two (at least
        ``min_seq_bucket``); a length past every explicit bucket stays as
        it is (data is never truncated)."""
        if self.seq_buckets:
            for b in self.seq_buckets:
                if t <= b:
                    return b
            return t
        return max(self.min_seq_bucket, _next_pow2(t))

    def apply(self, ds):
        """A shape-stabilised copy of a DataSet or MultiDataSet (host
        numpy arrays)."""
        if self.mode == "exact":
            return ds
        if isinstance(ds, MultiDataSet):
            out, padded = self._apply_multi(ds)
        else:
            out, padded = self._apply_single(ds)
        self._record(out, padded)
        return out

    def _apply_single(self, ds: DataSet):
        x = to_numpy(ds.features)
        y = to_numpy(ds.labels)
        fm = _norm_mask(None if ds.features_mask is None
                        else to_numpy(ds.features_mask))
        n = x.shape[0]
        target_n = max(self.batch_size or n, n)
        x, fm = self._pad_feature(x, fm, n)
        y, lm = self._pad_label(
            y, None if ds.labels_mask is None else to_numpy(ds.labels_mask),
            fm_orig=fm, n=n, target_n=target_n)
        pad_n = target_n - n
        if pad_n:
            x = _pad_axis(x, 0, pad_n)
            y = _pad_axis(y, 0, pad_n)
            lm = _pad_axis(lm, 0, pad_n)
            if fm is not None:
                # padded rows keep an all-ones features mask: their loss
                # is zeroed by the labels mask, and a fully masked row
                # would make masked max pooling -inf and then NaN
                fm = _pad_axis(fm, 0, pad_n, value=1.0)
        return DataSet(x, y, fm, lm), pad_n

    def _pad_feature(self, x, fm, n):
        """One [N,T,F] feature array (and its [N,T] mask) time-bucketed."""
        if self.mode != "bucket" or x.ndim != 3:
            return x, fm
        t = x.shape[1]
        if fm is None:
            fm = np.ones((n, t), np.float32)
        bt = self.bucket_t(t)
        if bt > t:
            x = _pad_axis(x, 1, bt - t)
            fm = _pad_axis(fm, 1, bt - t)
        return x, fm

    def _pad_label(self, y, lm, fm_orig, n, target_n):
        """The labels mask carrying the loss-keeping scale: real rows
        target_n / n, padding 0."""
        scale = target_n / float(n)
        lm = _norm_mask(lm)
        if y.ndim == 3:
            t_real = y.shape[1]
            if lm is None:
                # per-timestep labels: the features mask is the labels
                # mask (the fit loop's convention)
                if fm_orig is not None and fm_orig.shape[1] >= t_real:
                    lm = np.array(fm_orig[:, :t_real], np.float32)
                else:
                    lm = np.ones((n, t_real), np.float32)
            lm = np.asarray(lm, np.float32)
            if lm.ndim == 1 or lm.shape[1] != t_real:
                # per-example weights on sequence labels: one per real
                # step, the features mask still saying which are real
                lm = np.broadcast_to(lm.reshape(n, -1)[:, :1],
                                     (n, t_real)).copy()
                if fm_orig is not None and fm_orig.shape[1] >= t_real:
                    lm = lm * fm_orig[:, :t_real]
            lm = lm * scale
            if self.mode == "bucket":
                bt = self.bucket_t(t_real)
                if bt > t_real:
                    y = _pad_axis(y, 1, bt - t_real)
                    lm = _pad_axis(lm, 1, bt - t_real)
        else:
            if lm is None:
                lm = np.ones((n, 1), np.float32)
            lm = np.asarray(lm, np.float32) * scale
        return y, lm

    def _apply_multi(self, mds: MultiDataSet):
        feats = [to_numpy(a) for a in mds.features]
        labs = [to_numpy(a) for a in mds.labels]
        fms = [None if m is None else _norm_mask(to_numpy(m))
               for m in (mds.features_mask_arrays or [None] * len(feats))]
        lms = list(mds.labels_mask_arrays or [None] * len(labs))
        n = feats[0].shape[0]
        target_n = max(self.batch_size or n, n)
        pad_n = target_n - n
        new_f, new_fm = [], []
        for a, m in zip(feats, fms):
            a, m = self._pad_feature(a, m, n)
            a = _pad_axis(a, 0, pad_n)
            if m is not None:
                m = _pad_axis(m, 0, pad_n, value=1.0)
            new_f.append(a)
            new_fm.append(m)
        new_l, new_lm = [], []
        for a, m in zip(labs, lms):
            # the graph's fit has no features-mask-as-labels-mask rule:
            # an absent mask is all ones
            a, m = self._pad_label(a, None if m is None else to_numpy(m),
                                   fm_orig=None, n=n, target_n=target_n)
            new_l.append(_pad_axis(a, 0, pad_n))
            new_lm.append(_pad_axis(m, 0, pad_n))
        out = MultiDataSet(
            new_f, new_l,
            new_fm if any(m is not None for m in new_fm) else None, new_lm)
        return out, pad_n * len(feats)

    def _record(self, out, padded: int) -> None:
        self.padded_examples_total += padded
        if self.mode != "bucket":
            return
        if isinstance(out, MultiDataSet):
            key = tuple(tuple(a.shape) for a in (*out.features, *out.labels))
        else:
            key = (tuple(out.features.shape), tuple(out.labels.shape))
        if key in self._seen:
            self.bucket_hits_total += 1
        else:
            self._seen.add(key)
            self.bucket_misses_total += 1


class _StateTaggingIterator(DataSetIterator):
    """Tags each batch with the underlying iterator's state after it
    (``_iter_state``), so the prefetcher reports the position of the
    batch its consumer last took, not where the lookahead has got to."""

    def __init__(self, underlying: DataSetIterator):
        self.underlying = underlying
        # set by set_state(): the worker's epoch-opening reset() must keep
        # a just-restored position
        self._skip_next_reset = False

    def reset(self):
        if self._skip_next_reset:
            self._skip_next_reset = False
            return
        self.underlying.reset()

    def hasNext(self) -> bool:
        return self.underlying.hasNext()

    def next(self) -> DataSet:
        ds = self.underlying.next()
        try:
            ds._iter_state = self.underlying.get_state()
        except NotImplementedError:
            ds._iter_state = None
        return ds

    def batch(self) -> int:
        return self.underlying.batch()

    def resetSupported(self) -> bool:
        return self.underlying.resetSupported()


class _StagingSlot:
    """One page-locked staging buffer per array of a batch, and the event
    after the last copies out of them."""

    def __init__(self):
        self.buffers = []
        self.done: Optional[torch.cuda.Event] = None

    def view(self, j: int, src: torch.Tensor) -> torch.Tensor:
        nbytes = src.numel() * src.element_size()
        while len(self.buffers) <= j:
            self.buffers.append(None)
        buf = self.buffers[j]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                              pin_memory=True)
            self.buffers[j] = buf
        return buf[:nbytes].view(src.dtype).view(src.shape)


def _batch_arrays(ds):
    """A batch's arrays in order, features first: ``(arrays, number of
    feature arrays, rebuild)``, ``rebuild`` making a batch of the same kind
    from arrays in that order."""
    if isinstance(ds, MultiDataSet):
        groups = [ds.features, ds.labels, ds.features_mask_arrays,
                  ds.labels_mask_arrays]
        sizes = [len(g) for g in groups]

        def rebuild(out):
            parts, i = [], 0
            for n in sizes:
                parts.append(out[i:i + n])
                i += n
            return MultiDataSet(parts[0], parts[1], parts[2] or None,
                                parts[3] or None)

        return [a for g in groups for a in g], sizes[0], rebuild
    return ([ds.features, ds.labels, ds.features_mask, ds.labels_mask], 1,
            lambda out: DataSet(*out))


def _host_tensor(a) -> torch.Tensor:
    """A tensor of array ``a`` without a copy where numpy allows (64-bit
    numbers made 32-bit, as ``jax.device_put`` makes them)."""
    if torch.is_tensor(a):
        return a
    a = np.asarray(a)
    if a.dtype.kind not in "biuf":
        return numpy_to_tensor(a)
    if a.dtype.itemsize == 8:
        return numpy_to_tensor_narrowed(a)
    return torch.from_numpy(np.ascontiguousarray(a))


class DevicePrefetchIterator(DataSetIterator):
    """Host ETL and device copies ahead of the fit loop.

    - ``depth``: batches copied ahead (2: double buffering; 0: no threads,
      each batch copied when it is asked for).
    - ``policy``: a ``BatchShapePolicy`` (its ``batch_size`` from
      ``underlying.batch()`` when unset; the caller's policy is copied,
      not changed).
    - ``device``: where batches go, the CUDA card unless ``"cpu"`` is
      asked for.
    - ``dtype``: the features' dtype on the device (cast there after the
      copy); labels and masks keep theirs.

    ``shutdown()`` (or leaving a ``with`` block) stops and joins both
    threads; ``reset()`` reopens. An exception in either thread is raised
    again by the consumer's ``hasNext()`` / ``next()``.
    """

    _SENTINEL = object()

    def __new__(cls, underlying=None, *args, **kwargs):
        if cls is DevicePrefetchIterator \
                and isinstance(underlying, MultiDataSetIterator):
            cls = DevicePrefetchMultiIterator
        return object.__new__(cls)

    def __init__(self, underlying, depth: int = 2,
                 policy: Optional[BatchShapePolicy] = None,
                 mesh=None, device=None, dtype=None,
                 host_queue_size: int = 4,
                 transfer_retries: int = 0,
                 transfer_backoff: float = 0.05,
                 quarantine: bool = False):
        if mesh is not None:
            raise not_ported("DevicePrefetchIterator(mesh=...) (sharded "
                             "batches)", "A8")
        if transfer_retries or quarantine:
            raise not_ported("DevicePrefetchIterator(transfer_retries=..., "
                             "quarantine=...) (util/resilience.py)", "A9")
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self.underlying = underlying
        self.depth = int(depth)
        self.device = resolve_device(device)
        self._dtype = dtype
        self._last_state = None
        self._tagged: Optional[_StateTaggingIterator] = None
        try:
            underlying.get_state()
        except (NotImplementedError, AttributeError):
            pass
        else:
            self._tagged = _StateTaggingIterator(underlying)
        self.policy = (policy if policy is not None
                       else BatchShapePolicy("exact"))
        if self.policy.batch_size is None and self.policy.mode != "exact":
            filled = None
            b = getattr(underlying, "batch", None)
            if callable(b):
                try:
                    filled = int(b()) or None
                except (TypeError, NotImplementedError):
                    filled = None
            if filled is None:
                raise ValueError(
                    f"BatchShapePolicy({self.policy.mode!r}) needs a "
                    "batch_size, and the underlying iterator does not "
                    "report one via batch(): pass "
                    "BatchShapePolicy(..., batch_size=N)")
            self.policy = BatchShapePolicy(
                self.policy.mode, batch_size=filled,
                min_seq_bucket=self.policy.min_seq_bucket,
                seq_buckets=self.policy.seq_buckets)
        self._host_queue_size = max(int(host_queue_size), 1)
        self._host: Optional[AsyncDataSetIterator] = None
        self._thread: Optional[threading.Thread] = None
        self._q: Optional[queue.Queue] = None
        self._stop: Optional[threading.Event] = None
        self._error: Optional[BaseException] = None
        self._peek = None
        self._exhausted = False
        self._consumed = False   # a next() since the last (re)start
        self._closed = False
        self._stream = None
        self._ring = None
        self._slot = 0
        self._copy_events = collections.deque(maxlen=COPY_EVENTS_KEPT)
        self.queue_depth = 0
        self.transfer_overlap_ms_total = 0.0
        self.transfer_overlap_batches = 0
        self.stage_ms_total = 0.0
        # the workers start at the first consumption: every fit loop
        # begins with reset(), which would discard an eager start's batches

    # ------------------------------------------------------- counters
    @property
    def padded_examples_total(self) -> int:
        return self.policy.padded_examples_total

    @property
    def bucket_hits_total(self) -> int:
        return self.policy.bucket_hits_total

    @property
    def bucket_misses_total(self) -> int:
        return self.policy.bucket_misses_total

    def copy_ms(self) -> list:
        """Each recent batch's host-to-device copies on the card (issued
        once the batch is staged), in ms from CUDA events; waits for them.
        Empty on the CPU."""
        return self._event_ms(1)

    def ready_ms(self) -> list:
        """Each recent batch's time on the side stream from its first copy
        to the end of its casts: when the consumer may take it."""
        return self._event_ms(2)

    def _event_ms(self, k: int) -> list:
        out = []
        for events in self._copy_events:
            events[k].synchronize()
            out.append(events[0].elapsed_time(events[k]))
        return out

    # ------------------------------------------------------- placement
    def _prepare(self, ds):
        """The policy, then the copies: ``(placed batch, issue time)``."""
        tag = getattr(ds, "_iter_state", None)
        ds = self.policy.apply(ds)
        arrays, n_features, rebuild = _batch_arrays(ds)
        dtypes = [self._dtype if j < n_features else None
                  for j in range(len(arrays))]
        t_issue = time.perf_counter()
        if self.device.type == "cuda":
            out, ready = self._to_card(arrays, dtypes)
        else:
            # a copy: a batch never shares the source's rows
            out = [None if a is None
                   else _host_tensor(a).to(self.device, copy=True)
                   for a in arrays]
            out = [a if a is None or dt is None else a.to(dt)
                   for a, dt in zip(out, dtypes)]
            ready = None
        placed = rebuild(out)
        placed._ready = ready
        placed._iter_state = tag
        return placed, t_issue

    def _to_card(self, arrays, dtypes):
        """Stage the host arrays in the next slot of the ring, then copy
        and cast on the side stream: ``(tensors, event after them)``."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._ring = [_StagingSlot() for _ in range(self.depth + 1)]
        slot = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        if slot.done is not None:
            # the buffers are free once their last copies have run
            slot.done.synchronize()
        t0 = time.perf_counter()
        staged = []
        for j, a in enumerate(arrays):
            if a is None or (torch.is_tensor(a) and a.device == self.device):
                staged.append((False, a))
                continue
            src = _host_tensor(a).cpu()
            stage = slot.view(j, src)
            stage.copy_(src)
            staged.append((True, stage))
        self.stage_ms_total += (time.perf_counter() - t0) * 1e3
        start, copied, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(3))
        with torch.cuda.stream(self._stream):
            start.record()
            moved = []
            for host, a in staged:
                if host:
                    t = torch.empty(a.shape, dtype=a.dtype, device=self.device)
                    t.copy_(a, non_blocking=True)
                    a = t
                moved.append(a)
            copied.record()
            out = []
            for (host, _), a, dtype in zip(staged, moved, dtypes):
                if a is None or dtype is None or a.dtype == dtype:
                    out.append(a)
                    continue
                if not host:
                    # made on another stream: cast after it
                    self._stream.wait_stream(
                        torch.cuda.default_stream(self.device))
                out.append(a.to(dtype))
            end.record()
        slot.done = copied
        self._copy_events.append((start, copied, end))
        return out, end

    def _hand_over(self, ds):
        """Order the consumer's stream after ``ds``'s copies, and mark its
        tensors as used there."""
        ev = getattr(ds, "_ready", None)
        if ev is None:
            return ds
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for t in _batch_arrays(ds)[0]:
            if torch.is_tensor(t) and t.device.type == "cuda":
                t.record_stream(cur)
        ds._ready = None
        return ds

    # ------------------------------------------------------- threading
    def _ensure_started(self) -> None:
        if self.depth == 0 or self._thread is not None or self._closed:
            return
        if self._host is None:
            self._host = AsyncDataSetIterator(
                self._tagged if self._tagged is not None
                else self.underlying, queue_size=self._host_queue_size)
        else:
            self._host.reset()   # reopen after shutdown
        self._start()

    def _start(self) -> None:
        # _last_state survives a (re)start: the lazy start after
        # set_state() keeps the restored position; reset() clears it
        self._error = None
        self._exhausted = False
        self._consumed = False
        self._peek = None
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self.depth)
        stop, q, host = self._stop, self._q, self._host
        index = self.device.index if self.device.type == "cuda" else None

        def worker():
            try:
                if index is not None:
                    torch.cuda.set_device(index)
                while not stop.is_set() and host.hasNext():
                    item = self._prepare(host.next())
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # handed to the consumer
                self._error = e
            finally:
                while True:
                    try:
                        q.put(self._SENTINEL, timeout=0.5)
                        break
                    except queue.Full:
                        if not stop.is_set():
                            continue   # a slow consumer: wait for room
                        try:           # stopped and drained: make room
                            q.get_nowait()
                        except queue.Empty:
                            pass

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="DevicePrefetch-transfer")
        self._thread.start()

    def _stop_transfer(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        if not self._exhausted:
            while self._q.get() is not self._SENTINEL:
                pass
        self._thread.join()
        self._thread = None
        self._peek = None
        self._exhausted = True

    def shutdown(self) -> None:
        """Stop and join both threads and release the staging buffers.
        Idempotent; ``reset()`` reopens the pipeline."""
        self._closed = True
        self._exhausted = True
        if self._thread is not None:
            self._stop_transfer()
        if self._host is not None:
            self._host.shutdown()
        if self._ring is not None:
            for slot in self._ring:
                if slot.done is not None:
                    slot.done.synchronize()
            self._ring = None
            self._stream = None
            self._slot = 0

    def __enter__(self) -> "DevicePrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # ------------------------------------------------------- iteration
    def reset(self):
        if self._tagged is not None and self._tagged._skip_next_reset:
            # an explicit reset() after set_state() asks for the next
            # epoch from the restored counter: let it reach the iterator
            self._tagged._skip_next_reset = False
        if self.depth == 0:
            self._last_state = None
            self.underlying.reset()
            return
        self._closed = False
        if self._thread is None:
            self._exhausted = False   # reopen; the workers start lazily
            self._last_state = None
            return
        if not self._consumed and not self._exhausted \
                and self._error is None:
            # a running pipeline nobody took from is primed at the start
            # of an epoch already: keep its batches
            return
        self._stop_transfer()
        self._last_state = None
        self._host.reset()
        self._start()

    def hasNext(self) -> bool:
        if self.depth == 0:
            return self.underlying.hasNext()
        self._ensure_started()
        if self._exhausted:
            return False
        if self._peek is None:
            self.queue_depth = self._q.qsize()
            item = self._q.get()
            if item is self._SENTINEL:
                self._exhausted = True
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                return False
            ds, t_issue = item
            self.transfer_overlap_ms_total += (time.perf_counter()
                                               - t_issue) * 1e3
            self.transfer_overlap_batches += 1
            self._peek = ds
        return True

    def next(self):
        if self.depth == 0:
            ds, _ = self._prepare(self.underlying.next())
            return self._hand_over(ds)
        if not self.hasNext():
            raise StopIteration
        ds, self._peek = self._peek, None
        self._consumed = True
        tag = getattr(ds, "_iter_state", None)
        if tag is not None:
            self._last_state = tag
        return self._hand_over(ds)

    # ----------------------------------------------- checkpointable state
    def get_state(self) -> dict:
        """The position after the batch the consumer last took (not the
        lookahead's): restoring it produces every prefetched batch that
        was not consumed, and none twice."""
        if self.depth == 0:
            return {"underlying": self.underlying.get_state()}
        if self._tagged is None:
            raise NotImplementedError(
                f"{type(self.underlying).__name__} does not support state "
                "capture")
        if self._last_state is None:
            raise RuntimeError(
                "DevicePrefetchIterator.get_state: no batch consumed since "
                "the last reset; the position is the epoch's start")
        return {"underlying": self._last_state}

    def set_state(self, state: dict) -> None:
        under_state = (state.get("underlying", state)
                       if isinstance(state, dict) else state)
        if self.depth == 0:
            self.underlying.set_state(under_state)
            self._last_state = under_state
            return
        if self._tagged is None:
            raise NotImplementedError(
                f"{type(self.underlying).__name__} does not support state "
                "restore")
        # the running pipeline holds batches of the old position
        if self._thread is not None:
            self._stop_transfer()
        if self._host is not None:
            self._host.shutdown()
        self.underlying.set_state(under_state)
        self._tagged._skip_next_reset = True
        self._closed = False
        self._exhausted = False
        self._consumed = False
        self._last_state = under_state

    def batch(self) -> int:
        if self.policy.mode != "exact" and self.policy.batch_size:
            return self.policy.batch_size
        b = getattr(self.underlying, "batch", None)
        if callable(b):
            return b()
        raise NotImplementedError(
            f"{type(self.underlying).__name__} does not expose batch()")

    def resetSupported(self) -> bool:
        sup = getattr(self.underlying, "resetSupported", None)
        return sup() if callable(sup) else True

    def asyncSupported(self) -> bool:
        return False  # already asynchronous

    def configure_retries(self, *args, **kwargs) -> None:
        raise not_ported("DevicePrefetchIterator.configure_retries "
                         "(util/resilience.py)", "A9")


class DevicePrefetchMultiIterator(DevicePrefetchIterator,
                                  MultiDataSetIterator):
    """The MultiDataSetIterator-typed variant (``ComputationGraph.fit``
    takes its MultiDataSet path); ``DevicePrefetchIterator(multi_iter)``
    builds it."""


__all__ = ["BatchShapePolicy", "DevicePrefetchIterator",
           "DevicePrefetchMultiIterator"]
