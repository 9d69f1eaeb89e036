"""Op and graph validation by finite differences, and coverage: counterpart
of ``deeplearning4j_tpu/autodiff/validation.py``.

The analytic gradients are torch autograd's over the port's ops; the
check guards against an op that is not differentiable, numerically wrong
or silently stops gradients. Central differences run in float32, as in
JAX (which runs without x64).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Set

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ndarray.ndarray import to_numpy
from deeplearning4j_tpu_torch.ops import jax_rules as jr
from deeplearning4j_tpu_torch.ops.registry import get_op, list_ops


class GradCheckUtil:
    """Finite-difference check of a SameDiff graph's gradients
    (reference: GradCheckUtil#checkGradients)."""

    @staticmethod
    def checkGradients(sd, feeds: Dict[str, Any], eps: float = 1e-3,
                       max_rel_error: float = 0.05,
                       min_abs_error: float = 1e-4,
                       subsample: Optional[int] = 64,
                       seed: int = 0,
                       print_failures: bool = True) -> bool:
        """``sd.calculateGradients`` against central differences on every
        trainable variable (subsampled for large arrays). Each perturbed
        value is an f32 copy; the graph gets back the very tensor it
        held."""
        analytic = sd.calculateGradients(feeds)
        loss_names = list(sd._loss_variables)

        def loss_value() -> float:
            outs = sd.output(feeds, loss_names)
            return float(sum(torch.sum(outs[n]) for n in loss_names))

        rng = np.random.default_rng(seed)
        ok = True
        for vname in sd.trainable_names():
            held = sd._arrays[vname]
            base = np.array(to_numpy(held), dtype=np.float32)
            an = to_numpy(analytic[vname])
            flat = base.reshape(-1)
            idxs = np.arange(flat.size)
            if subsample is not None and flat.size > subsample:
                idxs = rng.choice(flat.size, size=subsample, replace=False)
            try:
                for i in idxs:
                    orig = flat[i]
                    flat[i] = orig + eps
                    sd._arrays[vname] = torch.from_numpy(base.copy()).to(
                        sd.device)
                    f_plus = loss_value()
                    flat[i] = orig - eps
                    sd._arrays[vname] = torch.from_numpy(base.copy()).to(
                        sd.device)
                    f_minus = loss_value()
                    flat[i] = orig
                    numeric = (f_plus - f_minus) / (2 * eps)
                    a = an.reshape(-1)[i]
                    abs_err = abs(numeric - a)
                    denom = max(abs(numeric), abs(a))
                    rel = abs_err / denom if denom > 0 else 0.0
                    if abs_err > min_abs_error and rel > max_rel_error:
                        ok = False
                        if print_failures:
                            print(f"GRADCHECK FAIL {vname}[{i}]: "
                                  f"analytic={a:.6g} numeric={numeric:.6g} "
                                  f"rel={rel:.4f}")
            finally:
                sd._arrays[vname] = held
        return ok


@dataclasses.dataclass
class TestCase:
    """One op validation case (reference: validation/TestCase).

    ``expected``: an array (or tuple) to compare the forward with, or a
    callable applied to the numpy inputs. ``device``: where the op runs
    (None: the CUDA card)."""

    op_name: str
    args: Sequence[Any]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    expected: Any = None
    grad_check: bool = True
    rtol: float = 1e-4
    atol: float = 1e-5
    grad_eps: float = 1e-3
    grad_rtol: float = 0.05
    # which args are differentiable floats (default: all float args)
    diff_args: Optional[Sequence[int]] = None
    device: Any = None

    __test__ = False  # not a pytest class


class OpValidation:
    """Runs TestCases and keeps coverage (reference: OpValidation fails
    the build on registered ops no test exercised)."""

    _validated: Set[str] = set()

    @classmethod
    def validate(cls, tc: TestCase) -> None:
        op = get_op(tc.op_name)
        dev = resolve_device(tc.device)
        args = [jr.as_tensor(a, dev) for a in tc.args]
        with jr.on_device(dev):
            out = op(*args, **tc.attrs)

        if tc.expected is not None:
            exp = tc.expected
            if callable(exp):
                exp = exp(*[np.asarray(a) for a in tc.args])
            outs = out if isinstance(out, (tuple, list)) else (out,)
            exps = exp if isinstance(exp, (tuple, list)) else (exp,)
            assert len(outs) == len(exps), \
                f"{tc.op_name}: {len(outs)} outputs vs {len(exps)} expected"
            for o, e in zip(outs, exps):
                np.testing.assert_allclose(
                    to_numpy(o), np.asarray(e), rtol=tc.rtol, atol=tc.atol,
                    err_msg=f"forward mismatch for op {tc.op_name!r}")

        if tc.grad_check:
            diff_idx = list(tc.diff_args) if tc.diff_args is not None else [
                i for i, a in enumerate(args) if a.is_floating_point()]

            def scalar_fn(*diff_vals):
                full = list(args)
                for j, i in enumerate(diff_idx):
                    full[i] = diff_vals[j]
                with jr.on_device(dev):
                    res = op(*full, **tc.attrs)
                if isinstance(res, (tuple, list)):
                    return sum(torch.sum(r) for r in res
                               if r.is_floating_point())
                return torch.sum(res)

            diff_vals = [args[i].detach().requires_grad_(True)
                         for i in diff_idx]
            analytic = torch.autograd.grad(scalar_fn(*diff_vals), diff_vals,
                                           allow_unused=True)
            with torch.no_grad():
                for j, (val, an) in enumerate(zip(diff_vals, analytic)):
                    base = np.array(to_numpy(val), dtype=np.float32)
                    an = (np.zeros_like(base) if an is None
                          else to_numpy(an))
                    flat = base.reshape(-1)

                    def at():
                        t = torch.from_numpy(base.copy()).to(dev)
                        return float(scalar_fn(*[
                            t if m == j else diff_vals[m]
                            for m in range(len(diff_vals))]))

                    for i in range(flat.size):
                        orig = flat[i]
                        flat[i] = orig + tc.grad_eps
                        f_plus = at()
                        flat[i] = orig - tc.grad_eps
                        f_minus = at()
                        flat[i] = orig
                        numeric = (f_plus - f_minus) / (2 * tc.grad_eps)
                        a = an.reshape(-1)[i]
                        abs_err = abs(numeric - a)
                        denom = max(abs(numeric), abs(a))
                        rel = abs_err / denom if denom > 0 else 0.0
                        assert abs_err <= 1e-3 or rel <= tc.grad_rtol, (
                            f"grad mismatch op={tc.op_name} arg{j}[{i}]: "
                            f"analytic={a:.6g} numeric={numeric:.6g}")

        cls._validated.add(tc.op_name)

    @classmethod
    def mark_validated(cls, *names: str) -> None:
        """Record ops exercised by other suites."""
        cls._validated.update(names)

    @classmethod
    def coverage_report(cls) -> Dict[str, Any]:
        all_ops = set(list_ops())
        return {
            "total": len(all_ops),
            "validated": sorted(cls._validated & all_ops),
            "unvalidated": sorted(all_ops - cls._validated),
        }
