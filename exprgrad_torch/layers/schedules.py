"""Learning-rate schedules WRITTEN IN THE LANGUAGE.

Each schedule is an ordinary scalar expression of ``epoch()`` (the
training-step counter instruction, reference parser.nim epoch seam), so
it compiles INTO the training program — no host callback per step, and
the scheduled rate rides inside the one-jit target like any other
kernel expression.  Every optimizer in :mod:`.base` takes ``eta`` as a
plain float or any of these expressions interchangeably: the DSL's
literal coercion makes ``-eta * update`` work for both.

Example::

    from exprgrad_torch.layers import adam, warmup_cosine
    opt = make_opt(adam, eta=warmup_cosine(0.01, warmup=5, total=100))

Schedules compose: ``warmup(cosine_decay(...), steps)`` etc.
"""

from __future__ import annotations

import math

from ..expr import Scalar, cos, epoch, minimum, pow_, select, to_scalar


def step_decay(rate: float, decay: float = 0.5, every: int = 10) -> Scalar:
    """``rate * decay^(epoch // every)`` — staircase decay."""
    return rate * pow_(decay, to_scalar(epoch() // every))


def exponential_decay(rate: float, gamma: float = 0.99) -> Scalar:
    """``rate * gamma^epoch`` — smooth exponential decay."""
    return rate * pow_(gamma, to_scalar(epoch()))


def cosine_decay(rate: float, total: int, floor: float = 0.0) -> Scalar:
    """Loshchilov & Hutter cosine annealing from ``rate`` to ``floor``
    over ``total`` epochs, flat at ``floor`` afterwards."""
    t = minimum(to_scalar(epoch()), float(total))
    return floor + (rate - floor) * 0.5 * (
        1.0 + cos(t * (math.pi / float(total)))
    )


def warmup(sched, steps: int):
    """Linear warmup: scale ``sched`` (a float or schedule expression) by
    ``epoch/steps`` while ``epoch < steps``."""
    ramp = to_scalar(epoch()) / float(steps)
    scaled = sched * ramp
    return select(epoch() < steps, scaled, sched)


def warmup_cosine(
    rate: float, warmup_steps: int, total: int, floor: float = 0.0
) -> Scalar:
    """Linear warmup into cosine annealing — the standard LM recipe."""
    return warmup(cosine_decay(rate, total, floor), warmup_steps)
