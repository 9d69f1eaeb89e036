"""Utilities: ``util.model_serializer`` (the ModelSerializer zips both
packages share: write, restore, the normalizer beside the model),
``util.resilience`` (the fault-tolerant fit: preemption bundles,
auto-resume, divergence rollback, the watchdog) and
``util.sharded_checkpoint`` (the sharded checkpoint's single-process
path)."""
