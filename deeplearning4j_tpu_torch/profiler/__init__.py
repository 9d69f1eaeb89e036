"""Observability of the port's training: counterpart of the training
half of ``deeplearning4j_tpu/profiler``.

- ``telemetry``: the metrics registry (Prometheus text and JSON), host
  spans and the Chrome trace, step phases, the card's memory watermarks;
- ``flops``: the card's peak rates, the one table MFU and the bounds of
  ``chip_smoke.py`` divide by;
- ``flight_recorder``: the bounded event ring and its incident dumps;
- ``chaos``: fault injection for the fault-tolerant fit
  (``util.resilience``) and the device prefetcher;
- ``model_health``: the in-step health monitor (per-layer norms, NaN
  provenance, MFU).

The JAX package's op profiler, request tracing, SLO engine, time-series
store and program registry are not ported (ROADMAP A7.7 and A10).
"""
