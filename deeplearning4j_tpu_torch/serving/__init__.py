"""Serving: the continuous-batching ``DecodeEngine`` (engine.py) over the
paged KV cache (kv_pages.py, float or fp8 pages), with cross-request KV
reuse — ``PrefixCache`` (prefix_cache.py) and ``SessionStore``
(sessions.py) — and speculative decoding (``SpecConfig``,
``NGramDraft``; spec_decode.py). Counterpart of
``deeplearning4j_tpu/serving`` without the fleet."""

from deeplearning4j_tpu_torch.serving.engine import (CapacityRejected,
                                                     DecodeEngine,
                                                     ServingRequest)
from deeplearning4j_tpu_torch.serving.kv_pages import PagePool
from deeplearning4j_tpu_torch.serving.prefix_cache import PrefixCache
from deeplearning4j_tpu_torch.serving.sessions import SessionStore
from deeplearning4j_tpu_torch.serving.spec_decode import (NGramDraft,
                                                          SpecConfig)

__all__ = ["DecodeEngine", "ServingRequest", "CapacityRejected", "PagePool",
           "PrefixCache", "SessionStore", "SpecConfig", "NGramDraft"]
