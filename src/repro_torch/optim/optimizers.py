"""Plain SGD with a learning-rate schedule (port of the part of
`repro.optim.optimizers` the paper protocol uses: lr 1e-3, constant).

API mirrors the JAX package's: ``opt.init(params) -> state``;
``opt.update(grads, state) -> (updates, state)``, where ``grads`` and
``updates`` are lists of tensors in leaf order; apply as ``p + u``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

Schedule = Callable[[int], float]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]   # (grads, state) -> (updates, state)


class SGDState(NamedTuple):
    step: int


def sgd(lr) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params) -> SGDState:
        del params
        return SGDState(step=0)

    def update(grads: list[torch.Tensor], state: SGDState):
        eta = sched(state.step)
        return [g * -eta for g in grads], SGDState(step=state.step + 1)

    return Optimizer(init, update)
