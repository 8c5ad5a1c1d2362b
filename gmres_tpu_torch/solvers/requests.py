"""What a solver's loop asks of its runner: operator applications and host
reads.

cg, bicgstab and GMRES (``solvers/cg.py``, ``bicgstab.py``, ``gmres.py``)
are written as generators of steps. Each application of A or M is a
request ``Apply(fn, v)`` that the runner answers with fn(v), and each read
of a device value that decides the loop is a request ``Read(t)`` that it
answers with ``t.tolist()``; everything else the solver computes itself.
``run`` is the runner of one solve: it answers each request at once, so a
solve runs as the plain loop it replaces, with the same operations in the
same order. ``solvers/batched.py`` drives one generator per lane of a
batched solve and answers the lanes' requests together: one
``torch.func.vmap`` application for the lanes that ask for the same
operator, one host read for the lanes that wait on a read.
"""

from __future__ import annotations

from typing import Callable, Generator, NamedTuple

import torch


class Apply(NamedTuple):
    """The request fn(v): an application of the solve's A or M."""

    fn: Callable
    v: torch.Tensor


class Read(NamedTuple):
    """The request t.tolist(): a device value the loop decides on."""

    t: torch.Tensor


def run(steps: Generator):
    """Drive one solve's steps, answering each request as it comes; returns
    the solve's result."""
    try:
        req = next(steps)
        while True:
            ans = req.fn(req.v) if isinstance(req, Apply) else req.t.tolist()
            req = steps.send(ans)
    except StopIteration as done:
        return done.value


def eager(fn: Callable) -> Callable:
    """A plain function as steps that make no request (a cycle that applies
    its operators itself, inside a runner of steps)."""
    def steps(*args):
        return fn(*args)
        yield  # noqa: unreachable; makes steps a generator function

    return steps
