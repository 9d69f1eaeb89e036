"""Parameter trees: nested dicts and lists of tensors in the JAX
package's layout, and the bridges to and from numpy.

A tree from any JAX model's ``init_params()`` (after ``jax.device_get``,
so its leaves are numpy arrays) carries over with :func:`params_from_jax`
and back with :func:`params_to_numpy`. :class:`FlatParams` holds a
tree's f32 leaves in one flat buffer, the port's counterpart of the flat
master layout in ``deeplearning4j_tpu/parallel/zero.py``.
:func:`mln_params_from_numpy` carries a JAX ``MultiLayerNetwork``'s
``params_list`` (a list of per-layer dicts) across.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested dict/list parameter tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def params_from_jax(np_tree, device=None,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Torch parameter tree from a JAX parameter tree after
    ``jax.device_get`` (numpy leaves; any array-like works), on
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32)).to(dev, dtype),
        np_tree)


def numpy_to_tensor(a) -> torch.Tensor:
    """A CPU tensor of numpy array ``a``'s dtype. A bfloat16 array (the
    ``ml_dtypes`` type that JAX hands back) goes across as its 16 bits,
    viewed as ``torch.bfloat16``, so no ``ml_dtypes`` is needed here."""
    a = np.asarray(a)
    if a.dtype.kind not in "biufc":
        if a.dtype.name != "bfloat16":
            raise TypeError(f"unsupported numpy dtype {a.dtype}")
        return bfloat16_from_bits(a)
    return torch.from_numpy(np.array(a))


def bfloat16_from_bits(a) -> torch.Tensor:
    """A CPU ``torch.bfloat16`` tensor of the 16-bit patterns in numpy
    array ``a`` (an ``ml_dtypes`` bfloat16 array, or the uint16 view that
    the JAX side's npz writer stores)."""
    return torch.from_numpy(np.array(np.asarray(a).view(np.int16))).view(
        torch.bfloat16)


def mln_params_from_numpy(layers, device=None,
                          dtype: torch.dtype = None) -> List[Dict[str, Any]]:
    """A ``MultiLayerNetwork.params_list`` from a JAX network's
    ``params_list`` after ``jax.device_get`` (one dict of numpy arrays per
    layer), on ``device`` (default: the CUDA card), each leaf in its own
    dtype unless ``dtype`` is given."""
    dev = resolve_device(device)
    return [{k: numpy_to_tensor(a).to(dev, dtype) for k, a in layer.items()}
            for layer in layers]


def params_to_numpy(tree) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: f32 numpy leaves."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


class FlatParams:
    """A parameter tree whose f32 leaves live in one flat buffer.

    ``master`` is the flat f32 buffer; ``tree`` has the input tree's
    structure, each leaf a view into ``master`` that requires grad, so a
    loss over ``tree`` differentiates into the leaves and an update
    written into ``master`` (in place) is what the next forward reads.
    ``grad`` is a flat buffer of the same size for the gathered
    gradient."""

    def __init__(self, tree):
        src = list(_leaves(tree))
        dev = src[0].device
        self.numel = sum(int(t.numel()) for t in src)
        self.master = torch.empty(self.numel, dtype=torch.float32, device=dev)
        self.grad = torch.empty_like(self.master)
        self.leaves: List[torch.Tensor] = []
        off = 0

        def place(t):
            nonlocal off
            n = int(t.numel())
            with torch.no_grad():
                view = self.master[off:off + n].view(t.shape)
                view.copy_(t)
            off += n
            self.leaves.append(view.requires_grad_(True))
            return view

        self.tree = tree_map(place, tree)

    def gather_grads(self, loss: torch.Tensor) -> torch.Tensor:
        """Backpropagate ``loss`` into :attr:`grad` (one flat f32 vector
        in the leaves' order). A leaf the loss does not reach gets a zero
        gradient, as ``jax.grad`` gives it."""
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                   for p, g in zip(self.leaves, grads)], out=self.grad)
        return self.grad
