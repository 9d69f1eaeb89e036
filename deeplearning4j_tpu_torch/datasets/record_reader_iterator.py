"""Background host prefetch: ``AsyncDataSetIterator``, counterpart of the
class of that name in ``deeplearning4j_tpu/datasets/record_reader_iterator.py``
(a worker thread and a bounded queue, so the fit loop does not wait on
host ETL). An exception in the worker is raised again by the consumer's
``hasNext()`` / ``next()``, never dropped.

The record-reader iterators of the JAX file read ``datavec`` records;
they are stand-ins here that raise with their ROADMAP.md item.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from deeplearning4j_tpu_torch.common import not_ported
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


class AsyncDataSetIterator(DataSetIterator):
    """Prefetches ``underlying``'s batches on a daemon thread into a queue
    of ``queue_size``. ``shutdown()`` stops and joins the thread;
    ``reset()`` restarts it at a new epoch."""

    _SENTINEL = object()

    def __init__(self, underlying: DataSetIterator, queue_size: int = 4):
        self.underlying = underlying
        self.queue_size = queue_size
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._peek = None
        self._exhausted = False     # the sentinel was consumed
        self._stop = threading.Event()
        self._start()

    def _start(self):
        self._error = None
        self._exhausted = False
        self._stop = threading.Event()
        self._q = queue.Queue(maxsize=self.queue_size)
        stop, q = self._stop, self._q

        def worker():
            try:
                self.underlying.reset()
                while not stop.is_set() and self.underlying.hasNext():
                    item = self.underlying.next()
                    # poll, so a stop request cannot wedge a producer
                    # blocked on a full queue
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
                            # a live consumer, only slow: wait for room
                            # rather than drop a batch
                            continue
                        # the consumer stopped us and drains: drop one
                        # stale item to make room for the sentinel
                        try:
                            q.get_nowait()
                        except queue.Empty:
                            pass

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="AsyncDataSet-ETL")
        self._thread.start()

    def _join_worker(self):
        """Stop the producer, drain to its sentinel, join."""
        if self._thread is None:
            return
        self._stop.set()
        if not self._exhausted:
            while self._q.get() is not self._SENTINEL:
                pass
        self._thread.join()
        self._thread = None

    def reset(self):
        self._join_worker()
        self._peek = None
        self._start()

    def shutdown(self):
        """Stop and join the worker without restarting it; a later
        ``reset()`` reopens the iterator."""
        self._join_worker()
        self._peek = None
        self._exhausted = True

    def hasNext(self) -> bool:
        if self._exhausted:
            return False
        if self._peek is None:
            item = self._q.get()
            if item is self._SENTINEL:
                self._exhausted = True
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                return False
            self._peek = item
        return True

    def next(self) -> DataSet:
        if not self.hasNext():
            raise StopIteration
        item, self._peek = self._peek, None
        return item

    def batch(self) -> int:
        return self.underlying.batch()


def _record_reader_stand_in(name: str):
    def __init__(self, *args, **kwargs):
        raise not_ported(f"{name} (it reads datavec records)", "A10")

    return type(name, (DataSetIterator,), {
        "__init__": __init__,
        "__doc__": f"Stand-in: ``{name}`` is not ported yet."})


RecordReaderDataSetIterator = _record_reader_stand_in(
    "RecordReaderDataSetIterator")
SequenceRecordReaderDataSetIterator = _record_reader_stand_in(
    "SequenceRecordReaderDataSetIterator")
RecordReaderMultiDataSetIterator = _record_reader_stand_in(
    "RecordReaderMultiDataSetIterator")


__all__ = ["AsyncDataSetIterator", "RecordReaderDataSetIterator",
           "SequenceRecordReaderDataSetIterator",
           "RecordReaderMultiDataSetIterator"]
