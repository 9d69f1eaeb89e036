"""Control flow for SameDiff graphs: counterpart of
``deeplearning4j_tpu/autodiff/control_flow.py`` (:29-531).

Branches and loop bodies are sub-graphs stored in the op's attributes as
plain dicts (variables, ops, outputs, arrays), so a graph with control
flow saves and loads in either package. Where JAX lowers them to
``lax.cond`` / ``lax.while_loop`` / ``lax.scan`` and selects on the
device, the port runs them eagerly: the predicate, the branch index and
each iteration's condition are read on the host, one synchronisation
with the card per branch or iteration.

Gradients follow JAX's two lowerings of ``while_loop``:

- ``max_trip_count`` set (a statically-bounded loop): a Python loop of at
  most that many steps that stops when the condition turns false and
  never runs the body after that (a dead iteration can poison the
  backward pass, :func:`while_loop`). autograd differentiates it, as JAX
  differentiates its masked scan;
- ``max_trip_count`` None (dynamic termination): the loop runs under
  ``no_grad`` inside :class:`_DynamicLoop`, whose backward raises. It
  fires only when a gradient reaches the loop, which is exactly when JAX
  would have to transpose its ``lax.while_loop``: a loop that carries
  only integer state, or lies off the gradient path, trains as in JAX.
  ``SameDiff.calculateGradients`` and ``fit`` turn the raise into JAX's
  documented error (:func:`rewrap_nondiff_loop_error`).

The static trip-count analysis (:func:`derive_trip_count`, :185-482) is a
copy of JAX's, over numpy; a constant sub-expression is folded through
the port's own registry on the CPU.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import register_op

ARG_PREFIX = "sg_in_"

#: host reads of a predicate, branch index or loop condition since the
#: last reset (each one a synchronisation with the card)
host_reads = 0


def subgraph_to_dict(sub, outputs: Sequence[str], n_in: int) -> Dict[str, Any]:
    """A traced child SameDiff as a dict; arrays stay numpy arrays until
    the graph is saved (``OpNode.to_dict`` makes them JSON)."""
    from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy

    return {
        "n_in": n_in,
        "outputs": list(outputs),
        "variables": [
            {"name": v.name, "type": v.vtype.value,
             "shape": list(v.shape) if v.shape is not None else None,
             "dtype": v.dtype}
            for v in sub._vars.values()],
        "ops": [n.to_dict() for n in sub._ops],
        "arrays": {k: to_numpy(a) for k, a in sub._arrays.items()},
    }


def _array_of(spec) -> np.ndarray:
    """A sub-graph array in either form: the in-memory ndarray, or the
    JSON dict (``{"data", "dtype"}``)."""
    if isinstance(spec, dict):
        return np.asarray(spec["data"], dtype=np.dtype(spec["dtype"]))
    return np.asarray(spec)


#: sub-graphs built by :func:`subgraph_fn`, by (id of the dict, device),
#: each beside its dict so that a reused id is never taken for it; the
#: least recently used go first past :data:`_BUILT_MAX`
_built: "OrderedDict[tuple, tuple]" = OrderedDict()
_BUILT_MAX = 256


def subgraph_fn(d: Dict[str, Any], device) -> Callable[..., Tuple]:
    """A sub-graph dict as ``fn(*args) -> tuple(outputs)``, its arrays on
    ``device``; the body runs the port's ops eagerly under whatever
    autograd mode the caller holds. Built once for each dict and device
    (the op node keeps its dict), so a branch or loop that runs every
    step copies its arrays to the device once."""
    key = (id(d), str(device))
    hit = _built.get(key)
    if hit is not None and hit[0] is d:
        _built.move_to_end(key)
        return hit[1]
    fn = _build_subgraph(d, device)
    _built[key] = (d, fn)
    if len(_built) > _BUILT_MAX:
        _built.popitem(last=False)
    return fn


def _build_subgraph(d: Dict[str, Any], device) -> Callable[..., Tuple]:
    from deeplearning4j_tpu_torch.autodiff.samediff import (
        OpNode, SameDiff, SDVariable, VariableType, as_tensor)

    sub = SameDiff(device=device)
    for vd in d["variables"]:
        v = SDVariable(
            sub, vd["name"], VariableType(vd["type"]),
            tuple(vd["shape"]) if vd["shape"] is not None else None,
            vd["dtype"])
        sub._vars[v.name] = v
    for od in d["ops"]:
        sub._ops.append(OpNode.from_dict(od))
    for name, spec in d["arrays"].items():
        sub._arrays[name] = as_tensor(_array_of(spec), sub.device)
    outputs = tuple(d["outputs"])
    arrays = dict(sub._arrays)

    def fn(*args):
        feeds = {f"{ARG_PREFIX}{i}": a for i, a in enumerate(args)}
        outs = sub._run(outputs, {**arrays, **feeds})
        return tuple(outs[o] for o in outputs)

    return fn


def _host_value(t) -> Any:
    """A scalar tensor read on the host (counted in :data:`host_reads`)."""
    global host_reads
    host_reads += 1
    return t.reshape(()).item() if isinstance(t, torch.Tensor) else t


def _device(*tensors):
    return jr.op_device(*tensors)


@register_op("if_cond")
def if_cond(pred, *operands, true_graph=None, false_graph=None):
    """The branch ``pred`` selects, run on ``operands``; only that branch
    runs (and is differentiated)."""
    dev = _device(pred, *operands)
    branch = true_graph if bool(_host_value(pred)) else false_graph
    res = subgraph_fn(branch, dev)(*operands)
    return res[0] if len(res) == 1 else tuple(res)


@register_op("case_graph")
def case_graph(branch_index, *operands, branches=None):
    """N-way branch: any index out of range, negative ones included, runs
    the last branch (TF's rule, which JAX puts in front of
    ``lax.switch``)."""
    dev = _device(branch_index, *operands)
    idx = int(_host_value(branch_index))
    if idx < 0 or idx >= len(branches):
        idx = len(branches) - 1
    res = subgraph_fn(branches[idx], dev)(*operands)
    return res[0] if len(res) == 1 else tuple(res)


@register_op("call_graph")
def call_graph(*args, graph=None):
    """A sub-graph called inline."""
    res = subgraph_fn(graph, _device(*args))(*args)
    return res[0] if len(res) == 1 else tuple(res)


class DynamicLoopGradient(RuntimeError):
    """A gradient reached a dynamically-terminated ``while_loop``."""


class _DynamicLoop(torch.autograd.Function):
    """A dynamic loop as one autograd node whose backward refuses."""

    @staticmethod
    def forward(ctx, run, *init):
        with torch.no_grad():
            return run(*init)

    @staticmethod
    def backward(ctx, *grads):
        raise DynamicLoopGradient(
            "a gradient reached a dynamically-terminated while_loop")


@register_op("while_loop")
def while_loop(*init_vars, cond_graph=None, body_graph=None,
               max_trip_count=None):
    """Loop the body over the loop variables while the condition holds.
    Each body output is cast to its loop variable's dtype. With
    ``max_trip_count`` the loop stops at that bound even while the
    condition still holds (JAX's masked scan of that length) and is
    differentiable; without it, it is inference-only (module
    docstring)."""
    dev = _device(*init_vars)
    cf = subgraph_fn(cond_graph, dev)
    bf = subgraph_fn(body_graph, dev)
    init = tuple(jr.as_tensor(v, dev) for v in init_vars)

    def cond(vs):
        return bool(_host_value(cf(*vs)[0]))

    def body(vs):
        out = bf(*vs)
        if len(out) != len(vs):
            raise ValueError(
                f"while body returned {len(out)} vars, expected {len(vs)}")
        return tuple(jr.as_tensor(o, dev).to(v.dtype)
                     for o, v in zip(out, vs))

    if max_trip_count is not None:
        vs = init
        for _ in range(int(max_trip_count)):
            if not cond(vs):
                break
            vs = body(vs)
    else:
        def run(*vs):
            while cond(vs):
                vs = body(vs)
            # outputs distinct from the inputs, as autograd wants them
            return tuple(v.clone() for v in vs)

        vs = _DynamicLoop.apply(run, *init)
    return vs[0] if len(vs) == 1 else tuple(vs)


# --------------------------------------------- static trip-count analysis
# A copy of JAX's (control_flow.py:172-482): importers and
# SameDiff.whileLoop call derive_trip_count at build time, while the loop
# variables' constant inits are still visible, and stamp the result on
# the op.

MAX_SCAN_TRIP = 16384

_CMP_OPS = {"lt", "lte", "gt", "gte"}
_FOLLOW_OPS = {"identity", "cast", "stop_gradient"}


def _array_value(spec):
    if isinstance(spec, dict):
        if "__ndarray__" in spec:
            return np.asarray(spec["__ndarray__"],
                              dtype=np.dtype(spec["dtype"]))
        if "data" in spec:
            return np.asarray(spec["data"], dtype=np.dtype(spec["dtype"]))
        return None
    return np.asarray(spec)


def _sg_producers(d):
    return {o: od for od in d["ops"] for o in od["outputs"]}


def _scalar_const(r):
    """A ("const", v) resolution holding one value, as a float."""
    if r is not None and r[0] == "const" \
            and np.asarray(r[1]).size == 1:
        return float(np.asarray(r[1]).reshape(()))
    return None


def _fold(op: str, vals, attrs, outputs, name):
    """A constant op evaluated on the CPU through the port's registry."""
    from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy
    from deeplearning4j_tpu_torch.ops.registry import get_op

    with jr.on_device("cpu"):
        out = get_op(op)(*(jr.as_tensor(v, "cpu") for v in vals), **attrs)
    if isinstance(out, (tuple, list)):
        out = out[outputs.index(name)]
    return to_numpy(out) if isinstance(out, torch.Tensor) else np.asarray(out)


def _resolve_val(d, producers, name, depth=0, memo=None):
    """A sub-graph tensor as ("arg", i) | ("const", value) | None,
    following value-preserving ops and folding all-constant ops."""
    if memo is None:
        memo = {}
    if name in memo:
        return memo[name]
    memo[name] = None
    if depth > 32:
        return None
    r = None
    if name.startswith(ARG_PREFIX):
        tail = name[len(ARG_PREFIX):]
        if tail.isdigit():
            r = ("arg", int(tail))
    if r is None and name in d["arrays"]:
        v = _array_value(d["arrays"][name])
        r = ("const", v) if v is not None else None
    elif r is None:
        od = producers.get(name)
        if od is None:
            pass
        elif od["op"] in _FOLLOW_OPS:
            r = _resolve_val(d, producers, od["inputs"][0], depth + 1,
                             memo)
        else:
            vals = []
            for i in od["inputs"]:
                ri = _resolve_val(d, producers, i, depth + 1, memo)
                if ri is None or ri[0] != "const":
                    vals = None
                    break
                vals.append(ri[1])
            if vals is not None:
                try:
                    r = ("const", _fold(od["op"], vals, od.get("attrs", {}),
                                        od["outputs"], name))
                except Exception:
                    r = None
    memo[name] = r
    return r


def _resolve_lin(d, producers, name, depth=0, memo=None, vmemo=None):
    """A sub-graph tensor as ``arg_i + offset``: (i, offset) or None."""
    if memo is None:
        memo = {}
    if vmemo is None:
        vmemo = {}
    if name in memo:
        return memo[name]
    memo[name] = None
    if depth > 32:
        return None
    r = _resolve_val(d, producers, name, memo=vmemo)
    if r is not None and r[0] == "arg":
        memo[name] = (r[1], 0.0)
        return memo[name]
    od = producers.get(name)
    if od is None:
        return None
    if od["op"] in _FOLLOW_OPS:
        memo[name] = _resolve_lin(d, producers, od["inputs"][0],
                                  depth + 1, memo, vmemo)
        return memo[name]
    if od["op"] in ("add", "sub") and len(od["inputs"]) == 2:
        ra = _resolve_val(d, producers, od["inputs"][0], memo=vmemo)
        rb = _resolve_val(d, producers, od["inputs"][1], memo=vmemo)
        la = _resolve_lin(d, producers, od["inputs"][0], depth + 1,
                          memo, vmemo)
        lb = _resolve_lin(d, producers, od["inputs"][1], depth + 1,
                          memo, vmemo)
        sa, sb = _scalar_const(ra), _scalar_const(rb)
        if od["op"] == "add":
            if la is not None and sb is not None:
                memo[name] = (la[0], la[1] + sb)
            elif lb is not None and sa is not None:
                memo[name] = (lb[0], lb[1] + sa)
        else:
            if la is not None and sb is not None:
                memo[name] = (la[0], la[1] - sb)
    return memo[name]


def _body_update(body_graph, i, producers):
    """How body output ``i`` evolves: ("same",), ("add", step) or None."""
    outs = body_graph["outputs"]
    if i >= len(outs):
        return None
    name = outs[i]
    r = _resolve_val(body_graph, producers, name)
    if r is not None and r[0] == "arg" and r[1] == i:
        return ("same",)
    od = producers.get(name)
    depth = 0
    while od is not None and od["op"] in _FOLLOW_OPS and depth < 32:
        od = producers.get(od["inputs"][0])
        depth += 1
    if od is None or od["op"] not in ("add", "sub"):
        return None
    ra = _resolve_val(body_graph, producers, od["inputs"][0])
    rb = _resolve_val(body_graph, producers, od["inputs"][1])
    if od["op"] == "add":
        for x, y in ((ra, rb), (rb, ra)):
            if (x is not None and x[0] == "arg" and x[1] == i
                    and y is not None and y[0] == "const"
                    and np.asarray(y[1]).size == 1):
                return ("add", float(np.asarray(y[1]).reshape(())))
    else:
        if (ra is not None and ra[0] == "arg" and ra[1] == i
                and rb is not None and rb[0] == "const"
                and np.asarray(rb[1]).size == 1):
            return ("add", -float(np.asarray(rb[1]).reshape(())))
    return None


def derive_trip_count(cond_graph, body_graph, init_consts):
    """A static upper bound on the loop's trip count, or None: the
    tightest conjunct of the condition of the form ``counter CMP bound``
    (directly, or a carried boolean the body recomputes) with a constant
    init, step and bound. ``init_consts`` holds each loop variable's
    numpy value where its init is a graph constant, else None."""
    cp = _sg_producers(cond_graph)
    bp = _sg_producers(body_graph)

    conjuncts: List[str] = []
    stack = [cond_graph["outputs"][0]]
    seen = set()
    while stack:
        nm = stack.pop()
        if nm in seen:
            continue
        seen.add(nm)
        od = cp.get(nm)
        if od is not None and od["op"] in _FOLLOW_OPS:
            stack.append(od["inputs"][0])
        elif od is not None and od["op"] == "logical_and":
            stack.extend(od["inputs"])
        else:
            conjuncts.append(nm)

    def as_bound(r):
        if r is None:
            return None
        if r[0] == "const":
            v = np.asarray(r[1])
            return float(v.reshape(())) if v.size == 1 else None
        j = r[1]
        upd = _body_update(body_graph, j, bp)
        if (upd == ("same",) and j < len(init_consts)
                and init_consts[j] is not None
                and np.asarray(init_consts[j]).size == 1):
            return float(np.asarray(init_consts[j]).reshape(()))
        return None

    def fail_point(ctr, off, op, bound):
        """Smallest m >= 0 where the comparison over ``c0 + m*step + off``
        fails, or None; integral values only (a float counter's rounding
        could undercount the true trip count)."""
        if ctr >= len(init_consts) or init_consts[ctr] is None \
                or np.asarray(init_consts[ctr]).size != 1:
            return None
        upd = _body_update(body_graph, ctr, bp)
        if upd is None or upd[0] != "add" or upd[1] == 0:
            return None
        c0 = float(np.asarray(init_consts[ctr]).reshape(())) + off
        step = upd[1]
        if not (c0.is_integer() and float(step).is_integer()
                and float(bound).is_integer()):
            return None
        if op in ("lt", "lte") and step > 0:
            m = math.ceil((bound - c0) / step) if op == "lt" \
                else math.floor((bound - c0) / step) + 1
        elif op in ("gt", "gte") and step < 0:
            m = math.ceil((c0 - bound) / -step) if op == "gt" \
                else math.floor((c0 - bound) / -step) + 1
        else:
            return None
        return max(0, int(m))

    def carried_cond_bound(j):
        """A carried boolean the body recomputes as ``counter CMP bound``:
        the value of iteration m gates iteration m + 1."""
        outs = body_graph["outputs"]
        if j >= len(outs):
            return None
        od = bp.get(outs[j])
        depth = 0
        while od is not None and od["op"] in _FOLLOW_OPS and depth < 32:
            od = bp.get(od["inputs"][0])
            depth += 1
        if od is None or od["op"] not in _CMP_OPS \
                or len(od["inputs"]) != 2:
            return None
        la = _resolve_lin(body_graph, bp, od["inputs"][0])
        lb = _resolve_lin(body_graph, bp, od["inputs"][1])
        ra = _resolve_val(body_graph, bp, od["inputs"][0])
        rb = _resolve_val(body_graph, bp, od["inputs"][1])
        op = od["op"]
        sa, sb = _scalar_const(ra), _scalar_const(rb)
        if la is not None and sb is not None:
            ctr, off, bound = la[0], la[1], sb
        elif lb is not None and sa is not None:
            ctr, off, bound = lb[0], lb[1], sa
            op = {"lt": "gt", "lte": "gte", "gt": "lt", "gte": "lte"}[op]
        else:
            return None
        m = fail_point(ctr, off, op, bound)
        return None if m is None else m + 1

    bounds: List[int] = []
    for nm in conjuncts:
        od = cp.get(nm)
        r = _resolve_val(cond_graph, cp, nm)
        if r is not None and r[0] == "arg":
            cb = carried_cond_bound(r[1])
            if cb is not None:
                bounds.append(cb)
            continue
        if od is None or od["op"] not in _CMP_OPS or len(od["inputs"]) != 2:
            continue
        ra = _resolve_val(cond_graph, cp, od["inputs"][0])
        rb = _resolve_val(cond_graph, cp, od["inputs"][1])
        op = od["op"]
        if ra is not None and ra[0] == "arg" and as_bound(ra) is None:
            ctr, bound = ra[1], as_bound(rb)
        elif rb is not None and rb[0] == "arg":
            ctr, bound = rb[1], as_bound(ra)
            op = {"lt": "gt", "lte": "gte", "gt": "lt", "gte": "lte"}[op]
        else:
            continue
        if bound is None:
            continue
        n = fail_point(ctr, 0.0, op, bound)
        if n is not None:
            bounds.append(n)
    if not bounds:
        return None
    n = min(bounds)
    return n if n <= MAX_SCAN_TRIP else None


def dynamic_loop_names(ops) -> List[str]:
    """The first output of every dynamically-terminated while_loop in
    ``ops`` (OpNodes or op dicts), sub-graphs included."""
    found: List[str] = []
    for od in ops:
        name = od.op_name if hasattr(od, "op_name") else od["op"]
        attrs = od.attrs if hasattr(od, "attrs") else od.get("attrs", {})
        if name == "while_loop" and attrs.get("max_trip_count") is None:
            found.append((od.outputs if hasattr(od, "outputs")
                          else od["outputs"])[0])
        for v in attrs.values():
            if isinstance(v, dict) and "ops" in v and "outputs" in v:
                found.extend(dynamic_loop_names(v["ops"]))
            elif isinstance(v, (list, tuple)):
                for b in v:
                    if isinstance(b, dict) and "ops" in b \
                            and "outputs" in b:
                        found.extend(dynamic_loop_names(b["ops"]))
    return found


def rewrap_nondiff_loop_error(e: BaseException, ops=()) -> None:
    """Turn :class:`DynamicLoopGradient` into JAX's documented error
    (its words, naming the loops); re-raise anything else untouched."""
    if not isinstance(e, DynamicLoopGradient):
        raise e
    names = dynamic_loop_names(ops)
    raise ValueError(
        "gradients flow through a dynamically-terminated while_loop"
        + (f" ({', '.join(names)})" if names else "")
        + ", which lowers to lax.while_loop — JAX cannot "
        "reverse-differentiate it, so this loop is inference-only. "
        "Statically-bounded loops (constant trip count, e.g. imported "
        "dynamic RNNs / ONNX Loop with constant M) lower to a "
        "differentiable lax.scan automatically; a genuinely dynamic "
        "termination condition cannot be trained through. If the "
        "bound is actually static, ensure the loop counter's init and "
        "bound are graph constants at import/build time.") from e
