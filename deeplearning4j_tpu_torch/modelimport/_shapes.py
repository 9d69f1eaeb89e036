"""Abstract shape evaluation shared by the model importers (TF and ONNX).

Where JAX's importers call ``jax.eval_shape`` on each emitted op, the
port runs the op on ``device="meta"`` tensors: the outputs' shapes and
dtypes come back, no data is touched. An op that needs a value on the
host (``.item()``) fails there, as a JAX op that needs a concrete value
fails ``eval_shape``; the caller then drops the aval, as JAX's does.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

_META = torch.device("meta")


class Aval(NamedTuple):
    """An abstract value: a shape and a torch dtype (JAX's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def meta_tensor(a: Aval) -> torch.Tensor:
    return torch.empty(a.shape, dtype=a.dtype, device=_META)


def avals_of(out) -> List[Aval]:
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    res = []
    for o in outs:
        if not isinstance(o, torch.Tensor):
            raise TypeError(f"op output of type {type(o).__name__}")
        res.append(Aval(tuple(o.shape), o.dtype))
    return res


def eval_shape(op_name: str, fn, ins: List[Aval], attrs) -> List[Aval]:
    """The avals of one op's outputs, from a run on meta tensors (JAX's
    ``jax.eval_shape``). The control-flow ops, which read a predicate or
    condition on the host when they run, are probed through their
    sub-graphs: a loop's outputs keep its variables' avals, a branch op
    takes its first branch's."""
    from deeplearning4j_tpu_torch.autodiff.control_flow import subgraph_fn
    from deeplearning4j_tpu_torch.ops.jax_rules import on_device

    if op_name == "while_loop":
        return list(ins)
    with on_device(_META), torch.no_grad():
        args = [meta_tensor(a) for a in ins]
        if op_name == "if_cond":
            return avals_of(subgraph_fn(attrs["true_graph"], _META)(
                *args[1:]))
        if op_name == "case_graph":
            return avals_of(subgraph_fn(attrs["branches"][0], _META)(
                *args[1:]))
        if op_name == "call_graph":
            return avals_of(subgraph_fn(attrs["graph"], _META)(*args))
        return avals_of(fn(*args, **attrs))


__all__ = ["Aval", "avals_of", "eval_shape", "meta_tensor"]
