"""Device-resident Lyapunov deficit queue (paper §IV-A, Eqns 12-15).

The Eqn-12 backlog is a float32 scalar in `FleetState`, advanced inside the
round with the realized consumption via `core.lyapunov.queue_advance`.
``per_slot_of`` reads the replenishment rate beta·R_m/k off the controller:
budgetless controllers (fixed) report +inf, which pins the queue at 0.
"""
from __future__ import annotations

import torch

from repro_torch.core.lyapunov import queue_advance

__all__ = ["init_leaf", "per_slot_of", "queue_advance"]

NO_BUDGET = float("inf")        # per-slot replenishment that pins q at 0


def init_leaf(value: float = 0.0, device="cpu") -> torch.Tensor:
    """The FleetState queue leaf: a scalar f32 backlog."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def per_slot_of(controller) -> float:
    """Replenishment rate of a controller's deficit queue, +inf if it has
    none."""
    dq = getattr(controller, "queue", None)
    if dq is None:
        return NO_BUDGET
    return float(dq.per_slot)
