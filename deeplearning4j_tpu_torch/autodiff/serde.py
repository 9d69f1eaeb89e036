"""SameDiff save and load: counterpart of
``deeplearning4j_tpu/autodiff/serde.py`` (:36-99), the same zip:

- ``graph.json``: variables (name, type, shape, dtype), ops (name, inputs,
  outputs, attrs) in graph order, loss variables, counters and the
  training configuration as its tagged object (``TrainingConfig``);
- ``arrays.npz``: the VARIABLE and CONSTANT values;
- ``updater_state.npz``: the updater state's leaves as ``leaf_<i>``, in
  ``jax.tree_util.tree_flatten``'s order (dict keys sorted, lists in
  order), so a resume is exact in either direction between the packages.

The port stores the two npz entries uncompressed (``graph.json`` is
deflated, as the JAX side deflates every entry); either package reads
either zip.

A graph saved by either package loads in the other. bfloat16 arrays are
stored as numpy writes the JAX side's ``ml_dtypes`` arrays, as 2-byte
void (``<V2``) holding the bit patterns, and are read back through
``graph.json``'s dtype.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import serde as cserde
from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy
from deeplearning4j_tpu_torch.params import (bfloat16_bits, tree_leaves,
                                             tree_unflatten)


def _npz_bytes(arrays: dict) -> bytes:
    out = {k: bfloat16_bits(t) if t.dtype == torch.bfloat16 else to_numpy(t)
           for k, t in arrays.items()}
    buf = io.BytesIO()
    np.savez(buf, **out)
    return buf.getvalue()


def save(sd, path, save_updater_state: bool = True) -> None:
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
        "training_config": (cserde.to_dict(sd.training_config)
                            if sd.training_config is not None else None),
    }
    # the arrays go in stored, not deflated: deflating f32 weights saves
    # little and took 94 s for BERT-base with its Adam state on the card's
    # host; a zip reader takes either (the JAX side deflates)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("graph.json", json.dumps(graph, indent=2))
        zf.writestr("arrays.npz", _npz_bytes(sd._arrays),
                    compress_type=zipfile.ZIP_STORED)
        if save_updater_state and sd._updater_state is not None:
            leaves = tree_leaves(sd._updater_state, sort_keys=True)
            zf.writestr("updater_state.npz", _npz_bytes(
                {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}),
                compress_type=zipfile.ZIP_STORED)


def load(path, load_updater_state: bool = True, device=None):
    from deeplearning4j_tpu_torch.autodiff.samediff import (
        OpNode, SameDiff, SDVariable, VariableType, as_tensor)

    with zipfile.ZipFile(path) as zf:
        graph = json.loads(zf.read("graph.json"))
        arrays = dict(np.load(io.BytesIO(zf.read("arrays.npz")),
                              allow_pickle=False))
        updater_raw = None
        if load_updater_state and "updater_state.npz" in zf.namelist():
            updater_raw = dict(np.load(io.BytesIO(
                zf.read("updater_state.npz")), allow_pickle=False))

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
    if graph.get("training_config") is not None:
        # registers TrainingConfig's tag
        from deeplearning4j_tpu_torch.autodiff import training  # noqa: F401

        sd.training_config = cserde.from_dict(graph["training_config"])

    if updater_raw is not None and sd.training_config is not None:
        # the state's structure from a fresh init, its leaves in order
        template = sd.training_config.updater.init_state(
            {n: sd._arrays[n] for n in sd.trainable_names()})
        n = len(tree_leaves(template, sort_keys=True))
        leaves = iter([as_tensor(updater_raw[f"leaf_{i}"], sd.device)
                       for i in range(n)])
        sd._updater_state = tree_unflatten(template, leaves, sort_keys=True)
    return sd
