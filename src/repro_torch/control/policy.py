"""Device-side frequency-control policies: ``(state, obs) -> (action, state)``.

A `ScanPolicy` is a pure step function on tensors plus its initial carry.
`DeviceScaleEngine.run_scanned` calls it each round on the card, so the
controller never reads a value back to the host.  The host-side controller
classes in `repro_torch.api.components` score with the same functions, so
both execution paths pick actions with the same float32 arithmetic.

  fixed_policy      constant raw a_i (the Alg.-2 bound applies in the round)
  lyapunov_policy   Eqn-15 drift-plus-penalty argmax over a in {1..n},
                    reading the Eqn-12 backlog off `CtlObs.queue`

The DQN head and the distilled table policy are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.energy import compute_energy
from repro_torch.core.lyapunov import v_schedule

__all__ = ["CtlObs", "ScanPolicy", "fixed_policy", "lyapunov_policy",
           "lyapunov_scores"]


class CtlObs(NamedTuple):
    """What a device-side policy sees each round: 0-d tensors."""
    round: torch.Tensor              # i64 global round counter
    cluster: torch.Tensor            # i64 cluster being scheduled
    queue: torch.Tensor              # f32 Eqn-12 deficit backlog
    cluster_loss: torch.Tensor       # f32 masked mean twin loss
    cluster_freq: torch.Tensor       # f32 straggler calibrated frequency
    mean_freq: torch.Tensor          # f32 mean calibrated frequency
    channel_good_frac: torch.Tensor  # f32 members in the good state
    energy_used: torch.Tensor        # f32 running energy tally


class ScanPolicy(NamedTuple):
    """A device-side controller: ``step(state, CtlObs) -> (a_raw, state)``
    plus the initial carry."""
    state: Any
    step: Callable[[Any, CtlObs], tuple]


def fixed_policy(a: int) -> ScanPolicy:
    a = int(a)

    def step(state, obs: CtlObs):
        return torch.full((), a, dtype=torch.int32,
                          device=obs.queue.device), state

    return ScanPolicy(state=(), step=step)


def lyapunov_scores(q, round_idx, loss, mean_freq, good_frac, *,
                    n_actions: int, kappa: float, f_star: float,
                    v0: float, v_growth: float) -> torch.Tensor:
    """P2 objective of every a in {1..n_actions}, Eqn 15:
    v·ΔF̂(a) − Q(i)·(a·Ê_cmp + Ê_com), vectorized over actions, in float32.

    Exponential loss decay toward ``f_star`` at rate ``kappa`` per local
    step; the comm term uses the good-state fraction as a rate proxy.
    """
    q = torch.as_tensor(q, dtype=torch.float32)
    dev = q.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    loss, good_frac = f32(loss), f32(good_frac)
    a = torch.arange(1, n_actions + 1, dtype=torch.float32, device=dev)
    v = v_schedule(f32(round_idx), v0, v_growth)
    pred = f_star + (loss - f_star) * torch.exp(-kappa * a)
    e_cmp = compute_energy(f32(mean_freq))
    e_com = e_cmp * (2.0 - good_frac)
    cost = a * e_cmp + e_com
    return v * (loss - pred) - q * cost


def lyapunov_policy(*, n_actions: int = 10, kappa: float = 0.08,
                    f_star: float = 0.1, v0: float = 1.0,
                    v_growth: float = 0.02) -> ScanPolicy:
    def step(state, obs: CtlObs):
        s = lyapunov_scores(obs.queue, obs.round, obs.cluster_loss,
                            obs.mean_freq, obs.channel_good_frac,
                            n_actions=n_actions, kappa=kappa, f_star=f_star,
                            v0=v0, v_growth=v_growth)
        return torch.argmax(s).to(torch.int32) + 1, state

    return ScanPolicy(state=(), step=step)
