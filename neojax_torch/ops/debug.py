"""Numerical-safety tooling: NaN/Inf checks, x64 parity runs
(``neojax.ops.debug``).

The reference's CI runs ASan/UBSan (SURVEY.md section 5); the functional
analogues here are an eager :func:`assert_finite`, :func:`checked` (the
counterpart of ``checkify``'s ``float_checks``: a dispatch mode that checks
every op's floating outputs, so the first op that turns finite inputs into
NaN or Inf raises, not only ``fn``'s return value), and a helper that reruns
a function in float64 for parity against the reference's f64 path and its
1e-9 bound.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["assert_finite", "checked", "x64_parity_error"]


def _leaves(tree) -> list:
    """Leaves of nested dicts (sorted keys, as ``jax.tree.leaves``), tuples
    and lists."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {key: _map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, item) for item in tree)
    return fn(tree)


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())


def assert_finite(x, name: str = "array") -> None:
    """Eager check (host sync) that all floating leaves are finite."""
    for i, leaf in enumerate(_leaves(x)):
        if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.inexact):
            finite = bool(np.all(np.isfinite(leaf)))
        elif _is_float(leaf):
            finite = bool(torch.all(torch.isfinite(leaf)))
        else:
            continue
        if not finite:
            raise FloatingPointError(f"{name}: leaf {i} contains NaN/Inf")


def _all_finite(tensors) -> bool:
    return all(bool(torch.all(torch.isfinite(t))) for t in tensors if t.numel())


# ops that return uninitialized memory: whatever bits they hold (NaN among
# them) are not a result, so they are not checked
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"})


class _FloatChecks(TorchDispatchMode):
    """Raise on the first op whose floating inputs are all finite and whose
    floating outputs are not (a host sync per op)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return func(*args, **kwargs)
        inputs = [t for t in tree_flatten((args, kwargs))[0] if _is_float(t)]
        finite_in = _all_finite(inputs)
        out = func(*args, **kwargs)
        if finite_in and not _all_finite([t for t in tree_flatten(out)[0] if _is_float(t)]):
            raise FloatingPointError(f"{func} produced NaN/Inf from finite inputs")
        return out


def checked(fn: Callable) -> Callable:
    """Wrap ``fn`` so that every torch op it runs is checked for NaN/Inf.

    Returns a function with the same signature; raises FloatingPointError
    on the first op that produces NaN or Inf from finite inputs::

        safe_step = debug.checked(partial(conv.step, config))
        state, out = safe_step(params, state, block)
    """

    def wrapper(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapper


def x64_parity_error(fn: Callable, *args) -> float:
    """Run ``fn`` as-is and with all floating tensor inputs promoted to
    float64; return the max abs difference of the floating outputs. Useful
    for verifying f32 accumulation order stays within the reference's 1e-5
    bound."""
    out32 = fn(*args)

    def promote(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf.to(torch.float64)
        return leaf

    out64 = fn(*_map(promote, args))
    err = 0.0
    for a, b in zip(_leaves(out32), _leaves(out64)):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            err = max(err, float(torch.max(torch.abs(a.to(torch.float64) - b.to(torch.float64)))))
    return err
