"""Lyapunov dynamic deficit queue (paper §IV-A, Eqn 12).

Turns the long-term resource budget of P1 into the per-slot
drift-plus-penalty objective P2:

    Q(i+1) = max{ Q(i) + (a_i E_cmp + E_com) - beta R_m / k, 0 }

    P2: argmax_a  v (F(w_{i-1}) - F(w_i)) - Q(i) (a_i E_cmp + E_com)

``v`` grows with the round index.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DeficitQueue(NamedTuple):
    q: torch.Tensor             # scalar (or per-cluster) f32 backlog
    budget: float               # beta * R_m: total resource budget
    horizon: int                # k: planned number of aggregations

    @property
    def per_slot(self):
        return self.budget / self.horizon


def init_queue(budget: float, horizon: int, shape=()) -> DeficitQueue:
    return DeficitQueue(q=torch.zeros(shape, dtype=torch.float32),
                        budget=float(budget), horizon=int(horizon))


def queue_advance(q, consumed, per_slot):
    """Eqn 12 on bare tensors.  An infinite ``per_slot`` (no budget) pins
    the queue at 0."""
    return torch.clamp(q + consumed - per_slot, min=0.0)


def step_queue(queue: DeficitQueue, consumed) -> DeficitQueue:
    """Eqn 12. ``consumed`` = a_i * E_cmp + E_com for the slot."""
    return queue._replace(q=queue_advance(queue.q, consumed, queue.per_slot))


def drift_penalty_reward(loss_prev, loss_cur, consumed, queue: DeficitQueue,
                         v: float):
    """Eqn 15: R = v (F(w_{i-1}) - F(w_i)) - Q(i) (a_i E_cmp + E_com)."""
    return v * (loss_prev - loss_cur) - queue.q * consumed


def v_schedule(round_idx, v0: float = 1.0, growth: float = 0.01):
    """v increases with training rounds (paper §IV-A)."""
    return v0 * (1.0 + growth * round_idx)
