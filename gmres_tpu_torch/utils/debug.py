"""Debug-mode checking for non-finite values.

Counterpart of ``gmres_tpu/utils/debug.py``. JAX stages its checks with
``checkify`` and raises after the computation; here each check runs
eagerly with ``torch.isfinite`` and raises ``NonFiniteError`` naming what
failed. A check reads one boolean back from the device, so on the card
every checked call synchronises the stream: a debugging aid, not for a
timed path.

* ``finite_checked(op, name)`` wraps an operator or preconditioner so that
  a non-finite output raises.
* ``run_checked(fn, *args)`` runs fn and raises when a wrapped operator
  failed inside it or a tensor in its result is non-finite. JAX's
  float checks also flag a NaN made inside fn and masked before its
  result; eager PyTorch has no such hook, so only wrapped operators and
  the result are checked.

The solvers report a non-finite residual as ``SolverStatus.BREAKDOWN``
without any of this.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


class NonFiniteError(RuntimeError):
    """A checked value held NaN or Inf."""


def _check(value: Any, name: str) -> None:
    """Raise NonFiniteError when a tensor in value (a tensor, a sequence, a
    dict or a dataclass of them) holds a non-finite entry."""
    if isinstance(value, torch.Tensor):
        if (value.is_floating_point() or value.is_complex()) and \
                not bool(torch.isfinite(value).all()):
            raise NonFiniteError(name + " produced non-finite values")
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _check(getattr(value, f.name), f"{name}.{f.name}")
    elif isinstance(value, dict):
        for k, v in value.items():
            _check(v, f"{name}[{k!r}]")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _check(v, f"{name}[{i}]")


def finite_checked(op: Callable, name: str = "operator") -> Callable:
    """Wrap y = op(x): raise NonFiniteError when y is not finite (elementwise
    ``isfinite``, never the overflow-prone isfinite(y·y))."""

    def wrapped(x):
        y = op(x)
        _check(y, name)
        return y

    return wrapped


def run_checked(fn: Callable, *args: Any, **kwargs: Any):
    """Run fn(*args, **kwargs); raise NonFiniteError on the first failed
    check of a wrapped operator inside it, or when its result holds a
    non-finite tensor."""
    out = fn(*args, **kwargs)
    _check(out, getattr(fn, "__name__", "result"))
    return out
