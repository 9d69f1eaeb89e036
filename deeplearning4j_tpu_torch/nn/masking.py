"""Features-mask validation for both networks: a copy of
``deeplearning4j_tpu/nn/masking.py`` (``validate_features_mask``,
``:10-27``)."""

from __future__ import annotations

import numpy as np
import torch


def validate_features_mask(fm, x, ctx: str = "input"):
    """A features mask for the ``[N, T, F]`` input ``x``, as an ``[N, T]``
    tensor on ``x``'s device: ``[N, T]`` or ``[N, T, 1]`` (numpy or a
    tensor) is taken, anything else raises ``NotImplementedError``
    (silently dropping a mask would train over padding). None passes
    through."""
    if fm is None:
        return None
    if not torch.is_tensor(fm):
        fm = np.asarray(fm)
        if fm.dtype == np.float64:
            fm = fm.astype(np.float32)
        fm = torch.from_numpy(np.ascontiguousarray(fm))
    fm = fm.to(x.device)
    if fm.dim() == 3 and fm.shape[-1] == 1:
        fm = fm[..., 0]
    if x.dim() != 3 or fm.dim() != 2 or fm.shape[1] != x.shape[1]:
        raise NotImplementedError(
            f"features mask shape {tuple(fm.shape)} not supported for "
            f"{ctx} of shape {tuple(x.shape)} — expected [N,T] (or "
            "[N,T,1]) matching a [N,T,F] sequence input")
    return fm


__all__ = ["validate_features_mask"]
