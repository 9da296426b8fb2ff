"""Minimal optimizer substrate (port of `repro.optim.optimizers`).

The paper trains with plain SGD (lr 1e-3); its convergence theorem uses the
inverse-time schedule η_t = 2/(µ(γ+t)).  Both are here, with momentum,
AdamW and a cosine schedule, as in the JAX package.

API mirrors the JAX package's: ``opt.init(params) -> state`` on the
param tree; ``opt.update(grads, state, params=None) -> (updates, state)``,
where ``grads``, ``params`` and ``updates`` are lists of tensors in leaf
order (every leaf K-stacked when the clients train together); apply as
``p + u``.  A schedule maps the step to a Python float, computed in f32
as JAX computes it.  The state stays in f32, as in JAX: AdamW's moments
are f32 whatever the params' dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.utils.pytree import tree_leaves

Schedule = Callable[[int], float]

_f32 = np.float32


def constant_schedule(lr: float) -> Schedule:
    return lambda step: lr


def inverse_time_schedule(mu: float, gamma: float) -> Schedule:
    """Theorem 1's η_t = 2 / (µ (γ + t)), in f32."""
    return lambda step: float(_f32(2.0) / (_f32(mu) * (_f32(gamma)
                                                      + _f32(step))))


def cosine_schedule(peak: float, total_steps: int, warmup: int = 0
                    ) -> Schedule:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a half cosine
    to 0 at ``total_steps``; f32 arithmetic, with the cosine correctly
    rounded as XLA's is (within one f32 ulp)."""
    def f(step):
        step = _f32(step)
        if step < warmup:
            return float(_f32(peak) * step / _f32(max(warmup, 1)))
        prog = np.clip((step - _f32(warmup)) / _f32(max(total_steps - warmup,
                                                        1)),
                       _f32(0.0), _f32(1.0))
        cos = _f32(math.cos(float(_f32(math.pi) * prog)))
        return float(_f32(peak * 0.5) * (_f32(1.0) + cos))
    return f


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]   # (grads, state, params) -> (updates, state)


class SGDState(NamedTuple):
    step: int


def sgd(lr) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params) -> SGDState:
        del params
        return SGDState(step=0)

    def update(grads: list[torch.Tensor], state: SGDState, params=None):
        del params
        eta = sched(state.step)
        return [g * -eta for g in grads], SGDState(step=state.step + 1)

    return Optimizer(init, update)


class MomentumState(NamedTuple):
    step: int
    velocity: list


def sgd_momentum(lr, beta: float = 0.9) -> Optimizer:
    """Heavy-ball SGD: v ← β·v + g, update −η·v."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params) -> MomentumState:
        return MomentumState(step=0, velocity=[
            torch.zeros_like(p) for p in tree_leaves(params)])

    def update(grads: list[torch.Tensor], state: MomentumState, params=None):
        del params
        eta = sched(state.step)
        vel = [beta * v + g for v, g in zip(state.velocity, grads)]
        return ([v * -eta for v in vel],
                MomentumState(step=state.step + 1, velocity=vel))

    return Optimizer(init, update)


class AdamWState(NamedTuple):
    step: int
    mu: list
    nu: list


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """Adam with bias correction and decoupled weight decay (the decay
    term scaled by η, as JAX's): moments in f32, updates in the params'
    dtype."""
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params) -> AdamWState:
        def zeros():
            return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in tree_leaves(params)]
        return AdamWState(step=0, mu=zeros(), nu=zeros())

    def update(grads: list[torch.Tensor], state: AdamWState,
               params: Optional[list[torch.Tensor]] = None):
        if params is None:
            raise ValueError("adamw's update needs the params (weight decay)")
        step = state.step + 1
        eta = sched(state.step)
        g32 = [g.to(torch.float32) for g in grads]
        mu = [b1 * m + (1 - b1) * g for m, g in zip(state.mu, g32)]
        nu = [b2 * v + (1 - b2) * torch.square(g)
              for v, g in zip(state.nu, g32)]
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        updates = [
            ((m / c1 / (torch.sqrt(v / c2) + eps)
              + weight_decay * p.to(torch.float32)) * -eta).to(p.dtype)
            for m, v, p in zip(mu, nu, params)]
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)
