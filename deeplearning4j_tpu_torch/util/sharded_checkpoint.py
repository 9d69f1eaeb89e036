"""Sharded checkpoints: counterpart of
``deeplearning4j_tpu/util/sharded_checkpoint.py``, its single-process
path.

A checkpoint is a directory of ``shards_p<process>.npz`` (every array of
this process, each under ``<path>@@rep`` since a single process holds it
whole, plus ``__step__``) and ``manifest.json`` (format, step, process
count, each array's global shape and dtype by its ``/``-joined tree path,
and the data iterator's state), written with numpy and renamed into
place. The JAX package's single-process checkpoints restore here, and
these restore there. A bf16 array is stored as its 16 bits (the manifest
names its dtype); a sharded restore, and a checkpoint written by more than
one process, raise ``not_ported(..., "A8")``.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.common import not_ported

_REP_KEY = "@@rep"
_STEP_KEY = "__step__"
#: torch dtypes stored as their bits (numpy has no such dtype)
_BITS = {torch.bfloat16: np.uint16}


def _flatten(tree, prefix="") -> Dict[str, torch.Tensor]:
    """``{"a/0/b": leaf}`` of a nested dict/list/tuple tree (dict keys
    sorted, None skipped), as the JAX package flattens it."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        out = [_unflatten(v, flat, f"{prefix}{i}/")
               for i, v in enumerate(template)]
        return tuple(out) if isinstance(template, tuple) else out
    if template is None:
        return None
    return flat[prefix[:-1]]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in _BITS:
        return t.view(torch.int16).numpy().view(_BITS[t.dtype])
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    dt = getattr(torch, dtype, None)
    if dt in _BITS:
        return torch.from_numpy(np.array(arr).view(np.int16)).view(dt)
    return torch.from_numpy(np.array(arr))


def _process() -> Tuple[int, int]:
    from deeplearning4j_tpu_torch.util.resilience import _host_identity

    return _host_identity()


class ShardedCheckpoint:
    FORMAT = "deeplearning4j_tpu-sharded-1"

    @staticmethod
    def save(dirpath: str, tree: Any, step: int = 0,
             iterator_state: Optional[Dict[str, Any]] = None) -> None:
        """Write this process's arrays and the manifest."""
        pidx, nproc = _process()
        if nproc != 1:
            raise not_ported("a sharded checkpoint of more than one "
                             "process", "A8")
        os.makedirs(dirpath, exist_ok=True)
        local: Dict[str, np.ndarray] = {}
        meta_paths: Dict[str, Dict[str, Any]] = {}
        for path, t in _flatten(tree).items():
            t = torch.as_tensor(t)
            meta_paths[path] = {"shape": list(t.shape),
                                "dtype": _dtype_name(t)}
            local[path + _REP_KEY] = _to_numpy(t)
        # the shard file names its step: a manifest of another step is a
        # torn checkpoint, not silently mixed state
        local[_STEP_KEY] = np.asarray(int(step), np.int64)
        buf = io.BytesIO()
        np.savez(buf, **local)
        tmp = os.path.join(dirpath, f".shards_p{pidx}.npz.tmp")
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, os.path.join(dirpath, f"shards_p{pidx}.npz"))
        manifest = {
            "format": ShardedCheckpoint.FORMAT,
            "step": int(step),
            "num_processes": nproc,
            "paths": meta_paths,
            "iterator_state": iterator_state,
        }
        mtmp = os.path.join(dirpath, ".manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(dirpath, "manifest.json"))

    @staticmethod
    def restore(dirpath: str, template: Any) -> Tuple[Any, Dict[str, Any]]:
        """The tree in ``template``'s structure, each array on its
        template leaf's device. Returns ``(tree, {step, iterator_state})``."""
        with open(os.path.join(dirpath, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest["format"] != ShardedCheckpoint.FORMAT:
            raise ValueError(
                f"not a sharded checkpoint: {manifest['format']!r}")
        pidx, nproc = _process()
        if manifest["num_processes"] != 1 or nproc != 1:
            raise not_ported("restoring a sharded checkpoint of "
                             f"{manifest['num_processes']} processes", "A8")
        shards = np.load(os.path.join(dirpath, f"shards_p{pidx}.npz"))
        if _STEP_KEY in shards and \
                int(shards[_STEP_KEY]) != int(manifest["step"]):
            raise ValueError(
                f"checkpoint is torn: this host's shard file is from "
                f"step {int(shards[_STEP_KEY])} but the manifest says "
                f"step {manifest['step']}")
        flat_out: Dict[str, torch.Tensor] = {}
        for path, tleaf in _flatten(template).items():
            info = manifest["paths"].get(path)
            if info is None:
                raise KeyError(f"checkpoint missing array {path!r}")
            tleaf = torch.as_tensor(tleaf)
            if tuple(info["shape"]) != tuple(tleaf.shape):
                raise ValueError(
                    f"{path}: checkpoint shape {info['shape']} != "
                    f"template {tuple(tleaf.shape)}")
            if path + _REP_KEY not in shards:
                raise not_ported(f"{path}: restoring per-device shards",
                                 "A8")
            flat_out[path] = _from_numpy(shards[path + _REP_KEY],
                                         info["dtype"]).to(tleaf.device)
        return _unflatten(template, flat_out), {
            "step": manifest["step"],
            "iterator_state": manifest.get("iterator_state")}

    @staticmethod
    def exists(dirpath: str) -> bool:
        return os.path.exists(os.path.join(dirpath, "manifest.json"))


# -------------------------------------------------- model-tree helpers
def model_checkpoint_tree(model) -> Dict[str, Any]:
    """The training state of a MultiLayerNetwork / ComputationGraph:
    parameters, layer state, updater state and, under loss scaling, the
    loss-scale state."""
    is_graph = hasattr(model, "params_map")
    tree: Dict[str, Any] = {
        "params": model.params_map if is_graph else model.params_list,
        "states": model.states_map if is_graph else model.states_list,
        "opt": model.opt_states,
    }
    if getattr(model, "_loss_scale_state", None) is not None:
        tree["loss_scale"] = model._loss_scale_state
    return tree


def save_model(dirpath: str, model, step: int = 0,
               iterator_state: Optional[Dict[str, Any]] = None) -> None:
    """``ShardedCheckpoint.save`` of :func:`model_checkpoint_tree`."""
    ShardedCheckpoint.save(dirpath, model_checkpoint_tree(model),
                           step=step, iterator_state=iterator_state)


def restore_model(dirpath: str, model) -> Dict[str, Any]:
    """A checkpoint into an initialised model (its trees are the
    template). Returns the checkpoint's ``{step, iterator_state}``."""
    tree, meta = ShardedCheckpoint.restore(dirpath,
                                           model_checkpoint_tree(model))
    if hasattr(model, "params_map"):
        model.params_map = tree["params"]
        model.states_map = tree["states"]
    else:
        model.params_list = tree["params"]
        model.states_list = tree["states"]
    model.opt_states = tree["opt"]
    if "loss_scale" in tree:
        model._loss_scale_state = tree["loss_scale"]
        model._ls_seen = (int(tree["loss_scale"]["overflows"]),
                          int(tree["loss_scale"]["skipped_steps"]))
    return meta


__all__ = ["ShardedCheckpoint", "model_checkpoint_tree", "save_model",
           "restore_model"]
