"""SameDiff save and load: counterpart of
``deeplearning4j_tpu/autodiff/serde.py`` (:36-99), the same zip:

- ``graph.json``: variables (name, type, shape, dtype), ops (name, inputs,
  outputs, attrs) in graph order, loss variables, counters and the
  training configuration;
- ``arrays.npz``: the VARIABLE and CONSTANT values.

A graph saved by either package loads in the other, ops and arrays
included. bfloat16 arrays are stored as numpy writes the JAX side's
``ml_dtypes`` arrays, as 2-byte void (``<V2``) holding the bit patterns,
and are read back through ``graph.json``'s dtype. ``updater_state.npz``
waits with ``fit`` (ROADMAP A10): it is neither written nor read; a
loaded training configuration is kept as JSON and written back as it
came.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy
from deeplearning4j_tpu_torch.params import bfloat16_bits


def _npz_bytes(arrays: dict) -> bytes:
    out = {k: bfloat16_bits(t) if t.dtype == torch.bfloat16 else to_numpy(t)
           for k, t in arrays.items()}
    buf = io.BytesIO()
    np.savez(buf, **out)
    return buf.getvalue()


def save(sd, path) -> None:
    graph = {
        "format_version": 1,
        "variables": [
            {"name": v.name, "type": v.vtype.value,
             "shape": (list(v.shape) if v.shape is not None else None),
             "dtype": v.dtype}
            for v in sd._vars.values()],
        "ops": [n.to_dict() for n in sd._ops],
        "loss_variables": sd._loss_variables,
        "iteration": sd._iteration,
        "epoch": sd._epoch,
        "training_config": sd._training_config,
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("graph.json", json.dumps(graph, indent=2))
        zf.writestr("arrays.npz", _npz_bytes(sd._arrays))


def load(path, device=None):
    from deeplearning4j_tpu_torch.autodiff.samediff import (
        OpNode, SameDiff, SDVariable, VariableType, as_tensor)

    with zipfile.ZipFile(path) as zf:
        graph = json.loads(zf.read("graph.json"))
        arrays = dict(np.load(io.BytesIO(zf.read("arrays.npz")),
                              allow_pickle=False))

    sd = SameDiff(device=device)
    for vd in graph["variables"]:
        v = SDVariable(sd, vd["name"], VariableType(vd["type"]),
                       tuple(vd["shape"]) if vd["shape"] is not None else None,
                       vd["dtype"])
        sd._vars[v.name] = v
    for od in graph["ops"]:
        sd._ops.append(OpNode.from_dict(od))
    for name, arr in arrays.items():
        declared = sd._vars[name].dtype if name in sd._vars else None
        if arr.dtype.kind == "V" and declared != "bfloat16":
            raise ValueError(f"arrays.npz: {name} holds raw {arr.dtype} "
                             f"bytes but graph.json says {declared}")
        sd._arrays[name] = as_tensor(arr, sd.device)
    sd._loss_variables = list(graph.get("loss_variables", []))
    sd._iteration = int(graph.get("iteration", 0))
    sd._epoch = int(graph.get("epoch", 0))
    sd._training_config = graph.get("training_config")
    return sd
