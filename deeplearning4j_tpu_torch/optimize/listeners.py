"""Training listeners: counterpart of
``deeplearning4j_tpu/optimize/listeners.py``.

Contract: ``iterationDone(model, iteration, epoch)`` after every step and
``onEpochEnd(model)`` after every epoch of ``fit`` over an iterator,
called on the host. A listener that reads ``model.score()`` waits for the
card there; the others do not touch the device. ``TelemetryListener``
raises: ``profiler/telemetry.py`` is not ported.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.common import not_ported

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    def iterationDone(self, model, iteration: int, epoch: int):
        pass

    def onEpochEnd(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    """Logs the score every N iterations (default 10)."""

    def __init__(self, print_iterations: int = 10, printer: Callable = None):
        self.n = max(1, print_iterations)
        self._print = printer or log.info

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.n == 0:
            self._print(f"Score at iteration {iteration} is {model.score()}")


class PerformanceListener(TrainingListener):
    """Batches and examples a second every ``frequency`` iterations, with
    the ETL wait that ``fit`` over an iterator records for the last batch
    (``model._last_etl_ms``: time blocked in the iterator's ``next()``)."""

    def __init__(self, frequency: int = 10, report_batch: bool = True,
                 printer: Callable = None):
        self.n = max(1, frequency)
        self.report_batch = report_batch
        self._print = printer or log.info
        self._last_time = None
        self._last_iter = 0
        self.samples_per_sec = float("nan")
        self.batches_per_sec = float("nan")
        self.etl_ms = None

    def iterationDone(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._last_time is None:
            self._last_time = now
            self._last_iter = iteration
            return
        if iteration - self._last_iter >= self.n:
            dt = now - self._last_time
            iters = iteration - self._last_iter
            self.batches_per_sec = iters / dt
            msg = (f"iteration {iteration}: {self.batches_per_sec:.2f} "
                   f"batches/sec")
            batch = getattr(model, "_last_batch_size", None)
            if self.report_batch and batch:
                self.samples_per_sec = self.batches_per_sec * batch
                msg += f", {self.samples_per_sec:.2f} samples/sec"
            self.etl_ms = getattr(model, "_last_etl_ms", None)
            if self.etl_ms is not None:
                msg += f", ETL {self.etl_ms:.3f} ms"
            self._print(msg + f", score {model.score():.5f}")
            self._last_time = now
            self._last_iter = iteration


class TimeIterationListener(TrainingListener):
    """Estimated time left, from the iterations done since the listener
    first fired (a resumed fit may start at any iteration)."""

    def __init__(self, total_iterations: int, printer: Callable = None,
                 frequency: int = 100):
        self.total = total_iterations
        self.n = max(1, frequency)
        self._start = None
        self._start_iter = None
        self._print = printer or log.info

    def iterationDone(self, model, iteration, epoch):
        if self._start is None:
            self._start = time.perf_counter()
            self._start_iter = iteration
            return
        elapsed = time.perf_counter() - self._start
        done = iteration - self._start_iter
        rate = done / max(elapsed, 1e-9)
        remaining = (self.total - iteration) / max(rate, 1e-9)
        if iteration % self.n == 0:
            self._print(f"iteration {iteration}/{self.total}, "
                        f"ETA {remaining:.0f}s")


class CollectScoresListener(TrainingListener):
    """(iteration, score) pairs every ``frequency`` iterations."""

    def __init__(self, frequency: int = 1):
        self.n = max(1, frequency)
        self.scores: List[tuple] = []

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.n == 0:
            self.scores.append((iteration, model.score()))


class CheckpointListener(TrainingListener):
    """A model zip every ``save_every_n_iterations``, the last
    ``keep_last`` kept. The list of checkpoints is read back from the
    directory at construction, so pruning carries over a restart; each
    save is ``ModelSerializer.writeModel``'s atomic, durable write."""

    _NAME_RE = re.compile(r"checkpoint_iter_(\d+)\.zip")

    def __init__(self, directory: str, save_every_n_iterations: int = 1000,
                 keep_last: int = 3, save_updater: bool = True):
        self.dir = directory
        self.every = save_every_n_iterations
        self.keep = keep_last
        self.save_updater = save_updater
        os.makedirs(directory, exist_ok=True)
        self._saved: List[str] = self._scan()

    def _scan(self) -> List[str]:
        """Checkpoints on disk, oldest (by iteration) first."""
        found = []
        for name in os.listdir(self.dir):
            m = self._NAME_RE.fullmatch(name)
            if m:
                found.append((int(m.group(1)), os.path.join(self.dir, name)))
        return [p for _, p in sorted(found)]

    def iterationDone(self, model, iteration, epoch):
        # iteration 0 is the untrained network
        if iteration == 0 or iteration % self.every != 0:
            return
        from deeplearning4j_tpu_torch.util.model_serializer import (
            ModelSerializer)

        path = os.path.join(self.dir, f"checkpoint_iter_{iteration}.zip")
        ModelSerializer.writeModel(model, path, self.save_updater)
        if path in self._saved:
            self._saved.remove(path)
        self._saved.append(path)
        while len(self._saved) > self.keep:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)

    def lastCheckpoint(self) -> Optional[str]:
        """The newest checkpoint, from this listener's list or, when that
        is empty, from the directory."""
        if self._saved:
            return self._saved[-1]
        on_disk = self._scan()
        return on_disk[-1] if on_disk else None


class TelemetryListener(TrainingListener):
    """Stand-in: the telemetry registry (``profiler/telemetry.py``) is not
    ported."""

    def __init__(self, frequency: int = 10):
        raise not_ported("TelemetryListener (profiler/telemetry.py)", "A9")


class EvaluativeListener(TrainingListener):
    """Held-out evaluation every ``frequency`` iterations."""

    def __init__(self, iterator, frequency: int = 100,
                 printer: Callable = None):
        self.iterator = iterator
        self.n = max(1, frequency)
        self._print = printer or log.info
        self.history: List[tuple] = []

    def iterationDone(self, model, iteration, epoch):
        if iteration % self.n != 0:
            return
        ev = model.evaluate(self.iterator)
        self.history.append((iteration, ev.accuracy()))
        self._print(f"iteration {iteration}: eval accuracy "
                    f"{ev.accuracy():.4f}")


__all__ = ["TrainingListener", "ScoreIterationListener",
           "PerformanceListener", "TimeIterationListener",
           "CollectScoresListener", "CheckpointListener",
           "TelemetryListener", "EvaluativeListener"]
