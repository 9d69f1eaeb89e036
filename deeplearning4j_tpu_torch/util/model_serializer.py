"""The read side of ``deeplearning4j_tpu/util/model_serializer.py``:
restores a ``MultiLayerNetwork`` from the zip that the JAX side's
``ModelSerializer.writeModel`` writes.

The zip holds ``configuration.json`` (the configuration's JSON),
``coefficients.npz`` (per-layer parameters, keys ``<idx>/<name>``),
``state.npz`` (non-trainable layer state), optionally
``updaterState.npz`` (the updater state tree, keys ``<idx>/m/<name>``
and so on) and ``meta.json`` (iteration and epoch counters). Arrays of a
dtype that numpy's npz cannot hold (bfloat16) are stored as a uint view
under ``<key>__as__<dtype>``; they are decoded here through torch, so no
``ml_dtypes`` is needed.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.params import (bfloat16_from_bits,
                                             numpy_to_tensor)


def read_npz(zf: zipfile.ZipFile, name: str) -> Dict[str, torch.Tensor]:
    """``{key: CPU tensor}`` of one npz member; a ``<key>__as__bfloat16``
    uint16 view becomes a bfloat16 tensor under ``<key>``."""
    with zf.open(name) as f:
        data = np.load(io.BytesIO(f.read()))
        out = {}
        for k in data.files:
            if "__as__" not in k:
                out[k] = numpy_to_tensor(data[k])
                continue
            key, dt = k.rsplit("__as__", 1)
            if dt != "bfloat16":
                raise NotImplementedError(
                    f"{name}: {k} holds {dt}, which the port does not read "
                    f"yet")
            out[key] = bfloat16_from_bits(data[k])
        return out


def _unflatten_into(template, flat, device, prefix=""):
    """``template``'s structure with every leaf from ``flat[path]`` moved
    to ``device`` (paths joined with ``/`` as the writer joins them)."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, device, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten_into(v, flat, device, f"{prefix}{i}/")
               for i, v in enumerate(template)]
        return tuple(out) if isinstance(template, tuple) else out
    if template is None:
        return None
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"the archive has no array {key!r}")
    t = flat[key]
    if tuple(t.shape) != tuple(template.shape):
        raise ValueError(f"{key}: archive shape {tuple(t.shape)} != model "
                         f"shape {tuple(template.shape)}")
    return t.to(device)


class ModelSerializer:
    @staticmethod
    def restoreMultiLayerNetwork(path: str, load_updater: bool = False,
                                 device=None):
        """A ``MultiLayerNetwork`` on ``device`` (default: the CUDA card)
        with the archive's configuration, parameters (each in its stored
        dtype), layer state, counters and, with ``load_updater``, updater
        state."""
        from deeplearning4j_tpu_torch.nn.conf.builder import (
            MultiLayerConfiguration)
        from deeplearning4j_tpu_torch.nn.multilayer.network import (
            MultiLayerNetwork)

        dev = resolve_device(device)
        with zipfile.ZipFile(path) as zf:
            conf = MultiLayerConfiguration.from_json(
                zf.read("configuration.json").decode())
            net = MultiLayerNetwork(conf, device=dev).init()
            net.params_list = _unflatten_into(
                net.params_list, read_npz(zf, "coefficients.npz"), dev)
            states = read_npz(zf, "state.npz")
            if states:
                net.states_list = _unflatten_into(net.states_list, states,
                                                  dev)
            if load_updater and "updaterState.npz" in zf.namelist():
                net.opt_states = _unflatten_into(
                    net.opt_states, read_npz(zf, "updaterState.npz"), dev)
            if "meta.json" in zf.namelist():
                meta = json.loads(zf.read("meta.json").decode())
                net._iteration = int(meta.get("iteration", 0))
                net._epoch = int(meta.get("epoch", 0))
        return net


__all__ = ["ModelSerializer", "read_npz"]
