"""SameDiff graph container: counterpart of
``deeplearning4j_tpu/autodiff/samediff.py``.

A graph is a list of registry-named op nodes in construction order (a
valid topological order: an op's inputs exist before it). ``output``
walks the ops that the requested outputs need, eagerly, calling each op
from the port's registry by name; ``calculateGradients`` runs the same
walk under torch autograd with the requested variables as leaves. Where
the JAX side traces the walk into one XLA program, the port runs it op by
op on the graph's device (``device=None`` means the CUDA card).

Ported: ``VariableType``, ``OpNode``, ``SDVariable`` (operators,
reductions, ``eval``, ``getArr``, ``setArray``, ``gradient``), the op
namespaces (``sd.math``, ``sd.nn``, ``sd.loss``, ...), and on
``SameDiff`` the variable factories, ``_op`` / ``invoke_op``, the
accessors, ``set_array``, ``convertConstantsToVariables``,
``setLossVariables``, ``output``, ``outputSingle``,
``calculateGradients``, ``grad``, ``summary``, ``save`` and ``load``
(``autodiff/serde.py``). Control flow, training and export raise
``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray.dtypes import DataType
from deeplearning4j_tpu_torch.ndarray.ndarray import _unwrap
from deeplearning4j_tpu_torch.ops.registry import get_op
from deeplearning4j_tpu_torch.params import numpy_to_tensor


class VariableType(enum.Enum):
    VARIABLE = "VARIABLE"
    CONSTANT = "CONSTANT"
    ARRAY = "ARRAY"
    PLACEHOLDER = "PLACEHOLDER"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to deeplearning4j_tpu_torch yet "
        f"(ROADMAP.md A10)")


def dtype_name(t: torch.Tensor) -> str:
    """The JAX side's dtype string of ``t`` ("float32", "bfloat16", ...)."""
    return DataType.from_any(t.dtype).value


def as_tensor(value, device) -> torch.Tensor:
    """``value`` (tensor, NDArray, numpy array or Python number) as a
    tensor on ``device``. 64-bit numbers from numpy or Python become 32-bit,
    as ``jnp.asarray`` makes them (JAX runs without x64)."""
    value = _unwrap(value)
    if isinstance(value, torch.Tensor):
        return value.to(device)
    a = np.asarray(value)
    narrow = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32}
    if a.dtype in narrow:
        a = a.astype(narrow[a.dtype])
    return numpy_to_tensor(a).to(device)


def _attrs_to_json(obj):
    """Deep-convert op attrs to JSON: arrays become tagged dicts."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        a = (obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor)
             else obj)
        return {"__ndarray__": a.tolist(), "dtype": str(a.dtype)}
    if isinstance(obj, dict):
        return {k: _attrs_to_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_attrs_to_json(v) for v in obj]
    return obj


def _attrs_from_json(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.asarray(obj["__ndarray__"],
                              dtype=np.dtype(obj["dtype"]))
        return {k: _attrs_from_json(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_attrs_from_json(v) for v in obj]
    return obj


class OpNode:
    """One graph node: a registry op and its static attrs."""

    __slots__ = ("op_name", "inputs", "outputs", "attrs")

    def __init__(self, op_name: str, inputs: List[str], outputs: List[str],
                 attrs: Dict[str, Any]):
        self.op_name = op_name
        self.inputs = inputs
        self.outputs = outputs
        self.attrs = attrs

    def to_dict(self) -> dict:
        return {"op": self.op_name, "inputs": self.inputs,
                "outputs": self.outputs,
                "attrs": _attrs_to_json(self.attrs)}

    @staticmethod
    def from_dict(d: dict) -> "OpNode":
        return OpNode(d["op"], list(d["inputs"]), list(d["outputs"]),
                      _attrs_from_json(dict(d["attrs"])))


class SDVariable:
    """Symbolic handle into a SameDiff graph (reference: SDVariable)."""

    def __init__(self, sd: "SameDiff", name: str, vtype: VariableType,
                 shape: Optional[Tuple[Optional[int], ...]] = None,
                 dtype: Optional[str] = None):
        self.sd = sd
        self.name = name
        self.vtype = vtype
        self.shape = shape
        self.dtype = dtype

    # ---------------------------------------------------- graph-building ops
    def _bin(self, op: str, other):
        if not isinstance(other, SDVariable):
            other = self.sd.constant_like(other)
        return self.sd._op(op, [self.name, other.name])

    def __add__(self, o):
        return self._bin("add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("rsub", o)

    def __mul__(self, o):
        return self._bin("mul", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("rdiv", o)

    def __pow__(self, o):
        return self._bin("pow_pairwise", o)

    def __neg__(self):
        return self.sd._op("neg", [self.name])

    def __matmul__(self, o):
        return self._bin("matmul", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __lt__(self, o):
        return self._bin("lt", o)

    def __ge__(self, o):
        return self._bin("gte", o)

    def __le__(self, o):
        return self._bin("lte", o)

    def add(self, o, name=None):
        return self._bin("add", o)

    def sub(self, o, name=None):
        return self._bin("sub", o)

    def mul(self, o, name=None):
        return self._bin("mul", o)

    def div(self, o, name=None):
        return self._bin("div", o)

    def mmul(self, o, name=None):
        return self._bin("matmul", o)

    def dot(self, o, name=None):
        return self._bin("matmul", o)

    def sum(self, *dims, keep_dims=False):
        return self.sd._op("reduce_sum", [self.name],
                           dimensions=list(dims) or None, keep_dims=keep_dims)

    def mean(self, *dims, keep_dims=False):
        return self.sd._op("reduce_mean", [self.name],
                           dimensions=list(dims) or None, keep_dims=keep_dims)

    def max(self, *dims, keep_dims=False):
        return self.sd._op("reduce_max", [self.name],
                           dimensions=list(dims) or None, keep_dims=keep_dims)

    def min(self, *dims, keep_dims=False):
        return self.sd._op("reduce_min", [self.name],
                           dimensions=list(dims) or None, keep_dims=keep_dims)

    def std(self, bias_corrected=True, *dims):
        return self.sd._op("reduce_std", [self.name],
                           dimensions=list(dims) or None,
                           bias_corrected=bias_corrected)

    def norm2(self, *dims):
        return self.sd._op("reduce_norm2", [self.name],
                           dimensions=list(dims) or None)

    def argmax(self, dimension=0):
        return self.sd._op("argmax", [self.name], dimensions=dimension)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return self.sd._op("reshape", [self.name], shape=list(shape))

    def transpose(self, *perm):
        return self.sd._op("transpose", [self.name],
                           permute=list(perm) or None)

    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self.name, new_name)
        return self

    # ------------------------------------------------------------ evaluation
    def eval(self, feeds: Optional[Dict[str, Any]] = None):
        """Execute the graph up to this variable."""
        return self.sd.output(feeds or {}, [self.name])[self.name]

    def getArr(self):
        """The stored array of a VARIABLE or CONSTANT; ``eval()`` for an
        ARRAY without placeholder inputs."""
        if self.name in self.sd._arrays:
            return self.sd._arrays[self.name]
        return self.eval()

    def setArray(self, arr):
        self.sd.set_array(self.name, arr)

    def gradient(self) -> Optional[torch.Tensor]:
        """The gradient from the last ``calculateGradients``."""
        return self.sd._last_grads.get(self.name)

    def __repr__(self):
        return (f"SDVariable(name={self.name!r}, type={self.vtype.value}, "
                f"shape={self.shape}, dtype={self.dtype})")


class _OpNamespace:
    """sd.math / sd.nn / sd.loss: emit graph nodes for any registered op
    (reference: SDMath/SDNN/SDLoss op factories)."""

    def __init__(self, sd: "SameDiff"):
        self._sd = sd

    def __getattr__(self, op_name: str):
        sd = self._sd
        try:
            get_op(op_name)  # fail fast on unknown ops
        except KeyError:
            # AttributeError keeps hasattr/copy/pickle probes working
            raise AttributeError(
                f"no registered op named {op_name!r}") from None

        def emit(*args, name: Optional[str] = None, **attrs):
            inputs = []
            for a in args:
                if isinstance(a, SDVariable):
                    inputs.append(a.name)
                else:
                    inputs.append(sd.constant_like(a).name)
            return sd._op(op_name, inputs, name=name, **attrs)

        return emit


class SameDiff:
    """A graph of named variables and registry ops on one device."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._arrays: Dict[str, torch.Tensor] = {}  # VARIABLE/CONSTANT values
        self._ops: List[OpNode] = []
        self._name_counter: Dict[str, int] = {}
        self._loss_variables: List[str] = []
        self._last_grads: Dict[str, torch.Tensor] = {}
        self._trainable_order: Optional[List[str]] = None
        self.math = _OpNamespace(self)
        self.nn = _OpNamespace(self)
        self.loss = _OpNamespace(self)
        self.cnn = _OpNamespace(self)
        self.rnn = _OpNamespace(self)
        self.image = _OpNamespace(self)
        self.random = _OpNamespace(self)
        self.linalg = _OpNamespace(self)
        self.bitwise = _OpNamespace(self)
        # what a loaded graph carried for training; written back by save()
        self._training_config: Optional[dict] = None
        self._iteration = 0
        self._epoch = 0

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device=device)

    # ---------------------------------------------------- variable creation
    def _unique(self, base: str) -> str:
        if base not in self._vars:
            return base
        n = self._name_counter.get(base, 0) + 1
        while f"{base}_{n}" in self._vars:
            n += 1
        self._name_counter[base] = n
        return f"{base}_{n}"

    def placeholder(self, name: str, shape=None, dtype="float32") -> SDVariable:
        """Reference: SameDiff#placeHolder. ``None``/-1 dims: batch dims."""
        name = self._unique(name)
        shape = tuple(None if (d is None or d == -1) else int(d)
                      for d in shape) if shape is not None else None
        v = SDVariable(self, name, VariableType.PLACEHOLDER, shape, dtype)
        self._vars[name] = v
        return v

    placeHolder = placeholder

    def _hold(self, name: str, vtype: VariableType, arr) -> SDVariable:
        arr = as_tensor(arr, self.device)
        v = SDVariable(self, name, vtype, tuple(arr.shape), dtype_name(arr))
        self._vars[name] = v
        self._arrays[name] = arr
        return v

    def var(self, name: str, arr=None, shape=None, dtype="float32",
            initializer: Optional[Callable] = None,
            generator: Optional[torch.Generator] = None) -> SDVariable:
        """Trainable variable: an explicit array, or a shape with an
        optional ``initializer(generator, shape)`` (zeros without one).
        Without a generator, one seeded by the variable count is used."""
        name = self._unique(name)
        if arr is None:
            if shape is None:
                raise ValueError("var() needs an array or a shape")
            if initializer is not None:
                if generator is None:
                    generator = torch.Generator().manual_seed(len(self._vars))
                arr = initializer(generator, tuple(shape))
            else:
                arr = torch.zeros(tuple(shape),
                                  dtype=DataType.from_any(dtype).torch)
        v = self._hold(name, VariableType.VARIABLE, arr)
        self._trainable_order = None
        return v

    def constant(self, name_or_value, value=None) -> SDVariable:
        """Reference: SameDiff#constant."""
        if value is None:
            name, value = "const", name_or_value
        else:
            name = name_or_value
        return self._hold(self._unique(name), VariableType.CONSTANT, value)

    def constant_like(self, value) -> SDVariable:
        return self.constant("const", value)

    def zero(self, name: str, *shape) -> SDVariable:
        return self.var(name, torch.zeros(shape))

    def one(self, name: str, *shape) -> SDVariable:
        return self.var(name, torch.ones(shape))

    # ------------------------------------------------------------ op emission
    def _op(self, op_name: str, inputs: List[str], n_out: int = 1,
            name: Optional[str] = None, **attrs) -> Any:
        base = name if name else op_name
        out_names = [self._unique(base if n_out == 1 else f"{base}:{i}")
                     for i in range(n_out)]
        self._ops.append(OpNode(op_name, list(inputs), out_names, attrs))
        outs = []
        for on in out_names:
            v = SDVariable(self, on, VariableType.ARRAY)
            self._vars[on] = v
            outs.append(v)
        return outs[0] if n_out == 1 else tuple(outs)

    def invoke_op(self, op_name: str, inputs: Sequence[SDVariable],
                  n_out: int = 1, name: Optional[str] = None, **attrs):
        """Emit any registered op into the graph by name."""
        return self._op(op_name, [v.name for v in inputs], n_out=n_out,
                        name=name, **attrs)

    def _rename(self, old: str, new: str) -> None:
        if new in self._vars:
            raise ValueError(f"variable exists: {new}")
        v = self._vars.pop(old)
        v.name = new
        self._vars[new] = v
        if old in self._arrays:
            self._arrays[new] = self._arrays.pop(old)
        for node in self._ops:
            node.inputs = [new if i == old else i for i in node.inputs]
            node.outputs = [new if o == old else o for o in node.outputs]
        self._loss_variables = [new if n == old else n
                                for n in self._loss_variables]
        self._trainable_order = None

    # ---------------------------------------------------------------- access
    def getVariable(self, name: str) -> SDVariable:
        return self._vars[name]

    def hasVariable(self, name: str) -> bool:
        return name in self._vars

    def variables(self) -> List[SDVariable]:
        return list(self._vars.values())

    def variableNames(self) -> List[str]:
        return list(self._vars)

    def trainable_names(self) -> List[str]:
        if self._trainable_order is None:
            self._trainable_order = [
                n for n, v in self._vars.items()
                if v.vtype is VariableType.VARIABLE]
        return self._trainable_order

    def set_array(self, name: str, arr) -> None:
        """Store ``arr`` (numpy, tensor or NDArray) for a VARIABLE or
        CONSTANT, on the graph's device."""
        v = self._vars[name]
        if v.vtype not in (VariableType.VARIABLE, VariableType.CONSTANT):
            raise ValueError(f"{name} is {v.vtype}; cannot hold an array")
        self._arrays[name] = as_tensor(arr, self.device)

    def convertConstantsToVariables(self, *names) -> None:
        """Promote CONSTANTs to trainable VARIABLEs (reference:
        SameDiff#convertConstantsToVariables); all names are checked before
        any is changed."""
        resolved = []
        for n in names:
            n = n.name if isinstance(n, SDVariable) else n
            if n not in self._vars:
                raise KeyError(f"no variable named {n!r}")
            v = self._vars[n]
            if v.vtype is not VariableType.CONSTANT:
                raise ValueError(f"{n} is {v.vtype.value}, not CONSTANT")
            resolved.append(v)
        for v in resolved:
            v.vtype = VariableType.VARIABLE
        self._trainable_order = None

    def setLossVariables(self, *names) -> None:
        self._loss_variables = [
            n.name if isinstance(n, SDVariable) else n for n in names]

    def getLossVariables(self) -> List[str]:
        return list(self._loss_variables)

    # ------------------------------------------------------------- execution
    def _prune(self, outputs: Tuple[str, ...]) -> List[OpNode]:
        """The ops that ``outputs`` need, in graph order."""
        produced = {o: node for node in self._ops for o in node.outputs}
        needed: List[OpNode] = []
        seen = set()
        stack = [o for o in outputs if o in produced]
        marked = set()
        while stack:
            name = stack.pop()
            if name in seen:
                continue
            seen.add(name)
            node = produced[name]
            if id(node) not in marked:
                marked.add(id(node))
                needed.append(node)
                stack.extend(i for i in node.inputs if i in produced)
        order = {id(n): i for i, n in enumerate(self._ops)}
        needed.sort(key=lambda n: order[id(n)])
        return needed

    def _run(self, outputs: Tuple[str, ...],
             env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Walk the pruned ops over ``env`` (variables and feeds)."""
        env = dict(env)
        for node in self._prune(outputs):
            res = get_op(node.op_name)(*(env[i] for i in node.inputs),
                                       **node.attrs)
            if len(node.outputs) == 1:
                env[node.outputs[0]] = res
            else:
                for on, r in zip(node.outputs, res):
                    env[on] = r
        return {o: env[o] for o in outputs}

    def _feeds(self, feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in feeds.items():
            if (k not in self._vars
                    or self._vars[k].vtype is not VariableType.PLACEHOLDER):
                raise ValueError(f"{k} is not a placeholder")
            out[k] = as_tensor(v, self.device)
        return out

    def output(self, feeds: Dict[str, Any],
               outputs: Sequence[Any]) -> Dict[str, torch.Tensor]:
        """Execute the graph (reference: SameDiff#output(Map, String...)):
        feeds go to the graph's device, no autograd is recorded."""
        out_names = tuple(o.name if isinstance(o, SDVariable) else o
                          for o in outputs)
        feeds = self._feeds(feeds)
        with torch.no_grad():
            return self._run(out_names, {**self._arrays, **feeds})

    def outputSingle(self, feeds: Dict[str, Any], output) -> torch.Tensor:
        name = output.name if isinstance(output, SDVariable) else output
        return self.output(feeds, [name])[name]

    # ------------------------------------------------------------- gradients
    def _loss_name(self) -> str:
        if not self._loss_variables:
            raise ValueError(
                "No loss variable set — call setLossVariables() first")
        return self._loss_variables[0]

    def calculateGradients(self, feeds: Dict[str, Any],
                           wrt: Optional[Sequence[str]] = None
                           ) -> Dict[str, torch.Tensor]:
        """Gradients of the sum of the loss variables with respect to
        ``wrt`` (default: every VARIABLE), by torch autograd over the
        eager walk. A variable the loss does not reach gets zeros, as
        ``jax.grad`` gives it. A gradient that would cross a forward-only
        op raises."""
        wrt_names = list(wrt) if wrt is not None else self.trainable_names()
        loss = self._loss_name()
        feeds = self._feeds(feeds)
        leaves = {n: self._arrays[n].detach().requires_grad_(True)
                  for n in wrt_names}
        with torch.enable_grad():
            outs = self._run(tuple(self._loss_variables),
                             {**self._arrays, **leaves, **feeds})
            total = outs[loss]
            for extra in self._loss_variables[1:]:
                total = total + outs[extra]
            total = total.sum()
            found = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        grads = {n: (torch.zeros_like(leaf) if g is None else g)
                 for (n, leaf), g in zip(leaves.items(), found)}
        self._last_grads = dict(grads)
        return grads

    def createGradFunction(self) -> None:
        """Reference API parity: gradients are taken on demand, so this
        only checks that a loss is set."""
        self._loss_name()

    def grad(self, var_name: str) -> Optional[torch.Tensor]:
        return self._last_grads.get(var_name)

    # ------------------------------------------------- waiting (ROADMAP A10)
    def ifCond(self, *args, **kwargs):
        raise _not_ported("SameDiff.ifCond")

    def whileLoop(self, *args, **kwargs):
        raise _not_ported("SameDiff.whileLoop")

    def setTrainingConfig(self, cfg) -> None:
        raise _not_ported("SameDiff.setTrainingConfig")

    def fit(self, *args, **kwargs):
        raise _not_ported("SameDiff.fit")

    def evaluate(self, *args, **kwargs):
        raise _not_ported("SameDiff.evaluate")

    def to_stablehlo(self, *args, **kwargs):
        raise _not_ported("SameDiff.to_stablehlo")

    # ----------------------------------------------------------------- serde
    def save(self, path, save_updater_state: bool = True) -> None:
        """The JAX side's zip (``graph.json`` + ``arrays.npz``). The port
        has no updater state yet, so ``save_updater_state`` writes
        nothing more."""
        from deeplearning4j_tpu_torch.autodiff.serde import save

        save(self, path)

    @staticmethod
    def load(path, load_updater_state: bool = True, device=None) -> "SameDiff":
        """A graph from the zip either package wrote, on ``device``. An
        archive's updater state is not read (``fit`` is not ported)."""
        from deeplearning4j_tpu_torch.autodiff.serde import load

        return load(path, device=device)

    def summary(self) -> str:
        lines = [f"{'name':<24}{'type':<14}{'op':<20}inputs"]
        producers = {o: n for n in self._ops for o in n.outputs}
        for name, v in self._vars.items():
            node = producers.get(name)
            lines.append(
                f"{name:<24}{v.vtype.value:<14}"
                f"{(node.op_name if node else '-'):<20}"
                f"{','.join(node.inputs) if node else '-'}")
        return "\n".join(lines)
