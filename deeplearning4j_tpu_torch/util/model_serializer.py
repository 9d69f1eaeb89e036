"""ModelSerializer: counterpart of
``deeplearning4j_tpu/util/model_serializer.py``. Writes and restores a
``MultiLayerNetwork`` or a ``ComputationGraph`` as the zip both packages
share, and the normalizer saved beside it.

The zip holds ``configuration.json`` (the configuration's JSON),
``coefficients.npz`` (parameters, keys ``<idx>/<name>`` per layer, or
``<node>/<name>`` per graph node), ``state.npz`` (non-trainable layer
state, keyed alike), optionally ``updaterState.npz`` (the updater state
tree, keys ``<idx>/m/<name>``, ``<node>/v/<name>`` and so on),
``meta.json`` (iteration and epoch counters, and ``model_type``),
``lossScaleState.npz`` when the model scales its loss (``mixed_float16``:
the live scale and its counters) and, when a normalizer is saved,
``normalizer.npz`` and ``normalizer.json``. Arrays of a dtype that numpy's
npz cannot hold (bfloat16, the float8 types) are stored as a same-width
uint view under ``<key>__as__<dtype>``; they are encoded and decoded here
through torch, so no ``ml_dtypes`` is needed. As in the JAX reader, a key
whose suffix names no dtype is kept whole (a vertex name may hold
``__as__``), and a suffix naming an ``ml_dtypes`` type that torch lacks
raises, naming it. A zip this module writes restores in the JAX package,
and the JAX package's restores here.
"""

from __future__ import annotations

import io
import json
import os
import uuid
import zipfile
from typing import Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.params import numpy_to_tensor


def fsync_directory(dirpath: str) -> None:
    """fsync a directory, so a rename inside it survives power loss
    (skipped where a directory cannot be opened)."""
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_replace(tmp: str, path: str) -> None:
    """fsync ``tmp``, rename it over ``path``, fsync the directory: after
    a crash at any point ``path`` is the old file or the whole new one."""
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    fsync_directory(os.path.dirname(os.path.abspath(path)))


def unique_tmp_path(path: str) -> str:
    """A sibling temp name no other writer shares."""
    return f"{path}.{os.getpid()}-{uuid.uuid4().hex[:8]}.tmp"


#: the ``ml_dtypes`` tags that torch has a dtype of the same width for,
#: decoded from (and encoded as) a uint view
_TORCH_TAGS = tuple(n for n in ("bfloat16", "float8_e4m3fn", "float8_e5m2",
                                "float8_e4m3fnuz", "float8_e5m2fnuz",
                                "float8_e8m0fnu") if hasattr(torch, n))
#: the other ``ml_dtypes`` types: a JAX archive may tag them, torch
#: cannot hold them
_ML_DTYPES_ONLY = ("float8_e3m4", "float8_e4m3", "float8_e4m3b11fnuz",
                   "float4_e2m1fn", "float6_e2m3fn", "float6_e3m2fn",
                   "int2", "int4", "uint2", "uint4")
#: an element's bits by its width: the torch view, the numpy type written
#: (unsigned, as the JAX writer's) and the numpy type read into torch
_BITS_BY_SIZE = {1: (torch.uint8, np.uint8, np.uint8),
                 2: (torch.int16, np.uint16, np.int16)}


def _tag(t) -> str:
    """The ``__as__`` tag of a tensor numpy cannot hold, or ''."""
    if torch.is_tensor(t):
        name = str(t.dtype).split(".", 1)[1]
        if name in _TORCH_TAGS:
            return name
    return ""


def _numpy_leaf(t) -> np.ndarray:
    """A leaf for an npz member: a tensor of a tagged dtype as its bits in
    a same-width uint (the writer's ``__as__<dtype>`` form), others as
    numpy."""
    if torch.is_tensor(t):
        t = t.detach().cpu()
        if _tag(t):
            tdt, ndt, _ = _BITS_BY_SIZE[t.element_size()]
            return t.view(tdt).numpy().view(ndt)
        return t.numpy()
    return np.asarray(t)


def _decode(arr: np.ndarray, tag: str, member: str, k: str):
    """The tensor of an ``<key>__as__<tag>`` array, or None where ``tag``
    names no dtype (the key is then a name that holds ``__as__``)."""
    if tag in _TORCH_TAGS:
        dt = getattr(torch, tag)
        size = torch.empty((), dtype=dt).element_size()
        return torch.from_numpy(np.array(arr.view(_BITS_BY_SIZE[size][2]))
                                ).view(dt)
    if tag in _ML_DTYPES_ONLY:
        raise NotImplementedError(
            f"{member}: {k} holds the ml_dtypes type {tag}, which torch has "
            f"no dtype for")
    try:
        return numpy_to_tensor(arr.view(np.dtype(tag)))
    except TypeError:
        return None


def _flatten_with_paths(tree, prefix="") -> Dict[str, np.ndarray]:
    """``{"a/0/b": array}`` of a nested dict/list/tuple tree (dict keys
    sorted; None leaves skipped), keys of leaves that numpy cannot hold
    suffixed ``__as__<dtype>``."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_with_paths(v, f"{prefix}{i}/"))
    elif tree is not None:
        key = prefix[:-1]
        if _tag(tree):
            key += "__as__" + _tag(tree)
        out[key] = _numpy_leaf(tree)
    return out


def _write_npz(zf: zipfile.ZipFile, name: str, arrays: dict) -> None:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    zf.writestr(name, buf.getvalue())


def _read_npz_numpy(zf: zipfile.ZipFile, name: str) -> dict:
    with zf.open(name) as f:
        data = np.load(io.BytesIO(f.read()))
        return {k: data[k] for k in data.files}


def _normalizer_registry():
    """The normalizer types ``restoreNormalizer`` rebuilds (each built
    with no arguments, then its state loaded)."""
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        ImagePreProcessingScaler, MultiNormalizerMinMaxScaler,
        MultiNormalizerStandardize, NormalizerMinMaxScaler,
        NormalizerStandardize, VGG16ImagePreProcessor)

    return {"NormalizerStandardize": NormalizerStandardize,
            "NormalizerMinMaxScaler": NormalizerMinMaxScaler,
            "ImagePreProcessingScaler": ImagePreProcessingScaler,
            "VGG16ImagePreProcessor": VGG16ImagePreProcessor,
            "MultiNormalizerStandardize": MultiNormalizerStandardize,
            "MultiNormalizerMinMaxScaler": MultiNormalizerMinMaxScaler}


def _check_composite_children(normalizer) -> None:
    """Refuse, before anything is written, a composite whose children
    could not be restored (nested composites, unknown types)."""
    registry = _normalizer_registry()
    for i, child in enumerate(normalizer.preprocessors):
        name = type(child).__name__
        if hasattr(child, "preprocessors"):
            raise ValueError(
                f"cannot save CompositeDataSetPreProcessor child {i} "
                f"({name}): nested composites are not restorable; flatten "
                "the children into one composite")
        if name not in registry:
            raise ValueError(
                f"cannot save CompositeDataSetPreProcessor child {i}: "
                f"{name} is not a restorable normalizer type (expected one "
                f"of {sorted(registry)})")


def read_npz(zf: zipfile.ZipFile, name: str) -> Dict[str, torch.Tensor]:
    """``{key: CPU tensor}`` of one npz member, as the JAX ``_read_npz``
    decodes it: a ``<key>__as__<dtype>`` uint view becomes a tensor of
    that dtype under ``<key>``; where the suffix names no dtype the key
    stays whole; a suffix naming an ``ml_dtypes`` type that torch lacks
    raises ``NotImplementedError`` naming it."""
    with zf.open(name) as f:
        data = np.load(io.BytesIO(f.read()))
        out = {}
        for k in data.files:
            if "__as__" in k:
                key, dt = k.rsplit("__as__", 1)
                t = _decode(data[k], dt, name, k)
                if t is not None:
                    out[key] = t
                    continue
            out[k] = numpy_to_tensor(data[k])
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


def _load_members(model, zf: zipfile.ZipFile, load_updater: bool, dev):
    """The archive's parameters (each in its stored dtype), layer state,
    counters and, with ``load_updater``, updater state, into an
    initialised ``model`` on ``dev``."""
    graph = hasattr(model, "params_map")
    params, states = (("params_map", "states_map") if graph
                      else ("params_list", "states_list"))
    setattr(model, params, _unflatten_into(
        getattr(model, params), read_npz(zf, "coefficients.npz"), dev))
    flat = read_npz(zf, "state.npz")
    if flat:
        setattr(model, states, _unflatten_into(getattr(model, states), flat,
                                               dev))
    if load_updater and "updaterState.npz" in zf.namelist():
        model.opt_states = _unflatten_into(
            model.opt_states, read_npz(zf, "updaterState.npz"), dev)
    _restore_loss_scale(model, zf, dev)
    if "meta.json" in zf.namelist():
        meta = json.loads(zf.read("meta.json").decode())
        model._iteration = int(meta.get("iteration", 0))
        model._epoch = int(meta.get("epoch", 0))
    return model


def _restore_loss_scale(model, zf: zipfile.ZipFile, dev) -> None:
    """``lossScaleState.npz`` into a model whose policy scales its loss
    (a member beside any other policy is ignored, as in the JAX reader);
    the telemetry baseline ``_ls_seen`` follows the restored counters."""
    if "lossScaleState.npz" not in zf.namelist() \
            or getattr(model, "_loss_scale_state", None) is None:
        return
    flat = read_npz(zf, "lossScaleState.npz")
    model._loss_scale_state = _unflatten_into(model._loss_scale_state, flat,
                                              dev)
    model._ls_seen = (int(flat.get("overflows", 0)),
                      int(flat.get("skipped_steps", 0)))


class ModelSerializer:
    @staticmethod
    def writeModel(model, path: str, save_updater: bool = True,
                   normalizer=None) -> None:
        """The model (and ``normalizer``) as a zip at ``path``, written to
        a temp file of this writer's own, fsynced and renamed into place:
        a reader never sees a partial file. ``save_updater`` adds the
        updater state."""
        if normalizer is not None and hasattr(normalizer, "preprocessors"):
            _check_composite_children(normalizer)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = unique_tmp_path(path)
        try:
            ModelSerializer._write_zip(model, tmp, save_updater, normalizer)
            atomic_replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    @staticmethod
    def _write_zip(model, path, save_updater, normalizer) -> None:
        graph = hasattr(model, "params_map")
        params = model.params_map if graph else model.params_list
        states = model.states_map if graph else model.states_list
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("configuration.json", model.conf.to_json())
            _write_npz(zf, "coefficients.npz", _flatten_with_paths(params))
            _write_npz(zf, "state.npz", _flatten_with_paths(states))
            if save_updater and model.opt_states is not None:
                _write_npz(zf, "updaterState.npz",
                           _flatten_with_paths(model.opt_states))
            if getattr(model, "_loss_scale_state", None) is not None:
                _write_npz(zf, "lossScaleState.npz",
                           _flatten_with_paths(model._loss_scale_state))
            meta = {"iteration": model.getIterationCount(),
                    "epoch": model.getEpochCount(),
                    "format": "deeplearning4j_tpu-1",
                    "model_type": type(model).__name__}
            zf.writestr("meta.json", json.dumps(meta))
            if normalizer is not None:
                info = {"type": type(normalizer).__name__}
                if hasattr(normalizer, "preprocessors"):
                    info["children"] = [type(p).__name__
                                        for p in normalizer.preprocessors]
                _write_npz(zf, "normalizer.npz",
                           _flatten_with_paths(normalizer.state_dict()))
                zf.writestr("normalizer.json", json.dumps(info))

    @staticmethod
    def loadInto(model, path: str, load_updater: bool = True):
        """The archive's parameters, layer state, counters, loss-scale
        state and (with ``load_updater``) updater state into an
        initialised ``model`` of the same architecture, on its device: the
        auto-resume path, which goes on training the caller's instance."""
        with zipfile.ZipFile(path) as zf:
            return _load_members(model, zf, load_updater, model.device)

    @staticmethod
    def restoreNormalizer(path: str):
        """The normalizer saved with the model, or None."""
        from deeplearning4j_tpu_torch.datasets.normalizers import (
            CompositeDataSetPreProcessor)

        registry = _normalizer_registry()
        with zipfile.ZipFile(path) as zf:
            if "normalizer.json" not in zf.namelist():
                return None
            info = json.loads(zf.read("normalizer.json").decode())
            state = _read_npz_numpy(zf, "normalizer.npz")
        if info["type"] == "CompositeDataSetPreProcessor":
            bad = [t for t in info["children"] if t not in registry]
            if bad:
                raise ValueError(
                    "cannot restore CompositeDataSetPreProcessor: children "
                    f"{bad} are not restorable normalizer types (expected "
                    f"one of {sorted(registry)})")
            n = CompositeDataSetPreProcessor(
                *[registry[t]() for t in info["children"]])
            # the writer joined the children's dicts as "p<i>/<key>"
            nested: dict = {f"p{i}": {} for i in range(len(info["children"]))}
            for k, v in state.items():
                head, rest = k.split("/", 1)
                nested[head][rest] = v
            n.load_state_dict(nested)
            return n
        if info["type"] not in registry:
            raise ValueError(
                f"cannot restore normalizer of type {info['type']!r} "
                f"(expected one of {sorted(registry)})")
        n = registry[info["type"]]()
        n.load_state_dict(state)
        return n

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
            return _load_members(net, zf, load_updater, dev)

    @staticmethod
    def restoreComputationGraph(path: str, load_updater: bool = True,
                                device=None):
        """A ``ComputationGraph`` on ``device`` (default: the CUDA card),
        restored as :meth:`restoreMultiLayerNetwork` restores a network,
        every tree keyed by node name; the updater state too unless
        ``load_updater`` is False (the reference's default)."""
        from deeplearning4j_tpu_torch.nn.graph.config import (
            ComputationGraphConfiguration)
        from deeplearning4j_tpu_torch.nn.graph.graph import ComputationGraph

        dev = resolve_device(device)
        with zipfile.ZipFile(path) as zf:
            conf = ComputationGraphConfiguration.from_json(
                zf.read("configuration.json").decode())
            graph = ComputationGraph(conf, device=dev).init()
            return _load_members(graph, zf, load_updater, dev)

    @staticmethod
    def restore(path: str, load_updater: bool = True, device=None):
        """Either model, by ``meta.json``'s ``model_type``."""
        dev = resolve_device(device)
        with zipfile.ZipFile(path) as zf:
            meta = json.loads(zf.read("meta.json").decode())
        if meta.get("model_type") == "ComputationGraph":
            return ModelSerializer.restoreComputationGraph(
                path, load_updater, device=dev)
        return ModelSerializer.restoreMultiLayerNetwork(
            path, load_updater, device=dev)


__all__ = ["ModelSerializer", "read_npz"]
