"""Peak rates of the card: counterpart of
``deeplearning4j_tpu/profiler/flops.py``, the one table that the model
health monitor's MFU and ``chip_smoke.py``'s bounds divide by.

Keyed by ``torch.cuda.get_device_name()`` and by compute dtype: the
H100 SXM's dense bf16 tensor-core rate, its f32 rate outside the tensor
cores, and its HBM3 bandwidth (NVIDIA's data sheet). An f32 workload
divided by the bf16 peak would read low by 15x, so the dtype picks the
row. A card without an entry gives None with one logged warning, and the
caller omits its MFU or bound rather than divide by a wrong peak.
"""

from __future__ import annotations

import logging

log = logging.getLogger("deeplearning4j_tpu_torch")

#: per-card peak FLOP/s by device name and compute dtype
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12},
}

#: per-card peak HBM bandwidth in GB/s (decimal GB) by device name
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

_warned_unknown_peak = set()
_warned_unknown_hbm = set()


def device_kind(device=None) -> str:
    """The name of the card ``device`` names (the current card for None),
    or ``"cpu"`` where there is no card or ``device`` is the CPU."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def _dtype_key(dtype) -> str:
    """``"bf16"`` for a 2-byte float type (bf16, f16), else ``"f32"``."""
    name = str(dtype).replace("torch.", "").lower()
    return "bf16" if name in ("bfloat16", "bf16", "float16", "f16",
                              "half") else "f32"


def peak_flops(dtype="bf16", device=None):
    """Peak FLOP/s of the card for a compute dtype (a torch dtype or its
    name). An unknown card (the CPU included) gives None, with a warning
    once per name."""
    kind = device_kind(device)
    entry = PEAK_FLOPS.get(kind)
    if entry is None:
        if kind not in _warned_unknown_peak:
            _warned_unknown_peak.add(kind)
            log.warning(
                "no peak-FLOPs entry for device %r: MFU will be omitted; "
                "add the card to profiler.flops.PEAK_FLOPS to enable it",
                kind)
        return None
    return entry.get(_dtype_key(dtype))


def peak_hbm_gbps(device=None):
    """Peak HBM bandwidth (GB/s) of the card; None, with a warning once,
    for an unknown card."""
    kind = device_kind(device)
    bw = PEAK_HBM_GBPS.get(kind)
    if bw is None and kind not in _warned_unknown_hbm:
        _warned_unknown_hbm.add(kind)
        log.warning(
            "no peak-HBM-bandwidth entry for device %r; add the card to "
            "profiler.flops.PEAK_HBM_GBPS", kind)
    return bw


__all__ = ["PEAK_FLOPS", "PEAK_HBM_GBPS", "device_kind", "peak_flops",
           "peak_hbm_gbps"]
