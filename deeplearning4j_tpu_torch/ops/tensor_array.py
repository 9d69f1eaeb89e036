"""TensorArray as a dense tensor: counterpart of
``deeplearning4j_tpu/ops/tensor_array.py`` (:23-62).

A TensorArray is a ``(size, *elem_shape)`` tensor carried as loop state:
write is a scatter of one row, read a gather, stack the identity. TF's
"flow" scalar, which orders a TensorArray's side effects, becomes the
tensor itself. TF2's TensorList ops share the representation. Indices
follow JAX's ``.at[]`` rules (``ops/jax_rules.py``): negatives count from
the end, rows out of range are dropped.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op


@register_op("tensorarray_reserve")
def tensorarray_reserve(size=None, elem_shape=(), dtype="float32"):
    """A TensorArray of ``size`` zero elements (TensorArrayV3 /
    TensorListReserve). With an unknown element shape it is a 1-D dummy
    that a full ``tensorarray_scatter`` (the unstack) replaces."""
    return torch.zeros((int(size),) + tuple(int(d) for d in elem_shape),
                       dtype=jr.torch_dtype(dtype), device=jr.op_device())


@register_op("tensorarray_write")
def tensorarray_write(flow, index, value):
    """TensorArrayWriteV3 / TensorListSetItem: ``out[index] = value``."""
    index = jr.as_tensor(index, flow.device).to(torch.int32).reshape(())
    return jr.scatter(flow, index, value.to(flow.dtype), "set")


@register_op("tensorarray_scatter")
def tensorarray_scatter(flow, indices, value):
    """TensorArrayScatterV3 (unstack): rows of ``value`` at ``indices``.
    Where ``flow`` already has the element shape, earlier writes at other
    indices stay (TF's rule); a dummy-reserved array (unknown element
    shape) is rebuilt from ``value``'s shape, unwritten rows zero."""
    indices = jr.as_tensor(indices, flow.device).to(torch.int32)
    if flow.shape[1:] == value.shape[1:]:
        return jr.scatter(flow, indices, value.to(flow.dtype), "set")
    base = torch.zeros((flow.shape[0],) + tuple(value.shape[1:]),
                       dtype=value.dtype, device=value.device)
    return jr.scatter(base, indices, value, "set")


@register_op("tensorarray_size")
def tensorarray_size(flow):
    """TensorArraySizeV3 / TensorListLength: the row count, int32."""
    return torch.tensor(flow.shape[0], dtype=torch.int32, device=flow.device)
