"""Faults planted under the program, for the tests that a broken program
is not correct. Each takes ``mp``, a ``pytest.MonkeyPatch`` or
:class:`Planted`, and breaks the timed path where the fault would lie.

A process that starts with ``plant/`` beside this file and the checkout's
root on its ``PYTHONPATH``, and ``PLANTED_FAULT=<name>`` in its
environment, plants ``FAULTS[<name>]`` before anything else runs
(``plant/sitecustomize.py``), so that a fault reaches every rank of a run:

    PLANTED_FAULT=no_exchange PYTHONPATH=benchmark/tests/plant:. \\
        python3 benchmark/run.py --workload xr1mr2c1.train-dp4 ...
"""

from __future__ import annotations

import operator
from pathlib import Path

import torch

PLANT = Path(__file__).resolve().parent / "plant"


class Planted:
    """``setattr`` and ``setitem`` for good, as a process's fault."""

    setattr = staticmethod(setattr)
    setitem = staticmethod(operator.setitem)


def no_step(mp) -> None:
    """The optimizer's step leaves the state unchanged."""
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(mp) -> None:
    """The loss leaves the second half of the batch out, its mean taken
    over the rest (under data parallelism too: its denominator is the
    rows it kept)."""
    from oaprogressionmmf_torch.ops import losses
    make = losses.dict_losses["FocalLoss"]

    class Half:
        def __init__(self, fn):
            self.fn = fn

        def __call__(self, logits, ys):
            return self.fn(logits[:len(ys) // 2], ys[:len(ys) // 2])

        def denominator(self, logits, ys):
            return self.fn.denominator(logits[:len(ys) // 2],
                                       ys[:len(ys) // 2])

    mp.setitem(losses.dict_losses, "FocalLoss", lambda **kw: Half(make(**kw)))


def no_exchange(mp) -> None:
    """Each rank keeps its own gradients: the all-reduce between the ranks
    is left out."""
    from oaprogressionmmf_torch.parallel import mesh
    mp.setattr(mesh.DataParallel, "all_reduce_grads",
               lambda self, params: None)


def altered_answer(mp) -> None:
    """A served answer's first knee gets its classes swapped."""
    from oaprogressionmmf_torch import serving
    call = serving.Predictor.__call__

    def altered(self, xs):
        p = call(self, xs).clone()
        p[0] = p[0].flip(0)
        return p
    mp.setattr(serving.Predictor, "__call__", altered)


FAULTS = {f.__name__: f for f in (no_step, half_batch, no_exchange,
                                  altered_answer)}
