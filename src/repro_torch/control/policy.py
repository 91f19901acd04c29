"""Device-side frequency-control policies: ``(state, obs) -> (action, state)``.

A `ScanPolicy` is a pure step function on tensors plus its initial carry.
`DeviceScaleEngine.run_scanned` calls it each round on the card, so the
controller never reads a value back to the host.  The host-side controller
classes in `repro_torch.api.components` score with the same functions, so
both execution paths pick actions with the same float32 arithmetic.

  fixed_policy      constant raw a_i (the Alg.-2 bound applies in the round)
  lyapunov_policy   Eqn-15 drift-plus-penalty argmax over a in {1..n},
                    reading the Eqn-12 backlog off `CtlObs.queue`
  dqn_policy        greedy head of a trained Alg.-1 DQN on the 48-dim
                    observation `CtlObs.dqn_obs`
  table_policy      a distilled lookup table (`distill_table`): the argmax
                    is resolved at distillation time, a select is three
                    nearest-bin searches and one gather

Argmax ties go to the first index in every policy, as ``jnp.argmax`` and
``torch.argmax`` both break them.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.dqn import q_values
from repro_torch.core.energy import compute_energy
from repro_torch.core.envs import OBS_DIM
from repro_torch.core.lyapunov import v_schedule

__all__ = ["CtlObs", "ScanPolicy", "fixed_policy", "lyapunov_policy",
           "lyapunov_scores", "dqn_policy", "deploy_obs", "distill_table",
           "table_policy", "PolicyTable"]


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
    # (OBS_DIM,) f32 §IV-B observation; the engine builds it only for
    # ``needs_obs`` policies (zeros otherwise)
    dqn_obs: Optional[torch.Tensor] = None


class ScanPolicy(NamedTuple):
    """A device-side controller: ``step(state, CtlObs) -> (a_raw, state)``
    plus the initial carry.  ``needs_obs`` tells the engine to build the
    48-dim DQN observation each round."""
    state: Any
    step: Callable[[Any, CtlObs], tuple]
    needs_obs: bool = False


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


# --------------------------------------------------------------------- #
# DQN greedy head
# --------------------------------------------------------------------- #
def dqn_policy(eval_params) -> ScanPolicy:
    """The trained net rides in the policy carry."""
    def step(state, obs: CtlObs):
        q = q_values(state, obs.dqn_obs)
        return torch.argmax(q).to(torch.int32) + 1, state

    return ScanPolicy(state=eval_params, step=step, needs_obs=True)


# --------------------------------------------------------------------- #
# distilled lookup table
# --------------------------------------------------------------------- #
class PolicyTable(NamedTuple):
    """Actions pre-argmaxed over a (loss x round x channel) grid."""
    table: torch.Tensor             # (L, R, G) int32 actions in {1..n}
    loss_grid: torch.Tensor         # (L,) f32 bin centres
    round_grid: torch.Tensor        # (R,) f32
    good_grid: torch.Tensor         # (G,) f32


def deploy_obs(loss, queue, round_frac, tau, round_mod, ch3, mean_freq, *,
               loss_max: float = 2.3) -> torch.Tensor:
    """The deployment-side §IV-B observation layout, in one place.

    Slots: [loss, loss_max - loss, Eqn-12 queue, round fraction, tau,
    one_hot(round_mod, 10), channel one-hot fractions (3), mean calibrated
    frequency, 0, 0, pad to OBS_DIM].  The scalar arguments are float32
    tensors of one shape S (broadcast), ``round_mod`` an integer tensor
    and ``ch3`` (..., 3); the result is (*S, OBS_DIM).  The engine's
    `_scan_obs` fills it from a live `FleetState`, `_grid_obs` with grid
    and neutral values for distillation.  It reads nothing back to the
    host (``one_hot`` with its class count given does not on CUDA).
    """
    loss, queue, round_frac, tau, mean_freq = torch.broadcast_tensors(
        loss, queue, round_frac, tau, mean_freq)
    shape = loss.shape
    one_hot = F.one_hot(torch.clamp(round_mod, max=9).to(torch.int64),
                        10).to(torch.float32).expand(*shape, 10)
    zero = torch.zeros_like(loss)
    feats = torch.cat([
        torch.stack([loss, loss_max - loss, queue, round_frac, tau], -1),
        one_hot, ch3.expand(*shape, 3),
        torch.stack([mean_freq, zero, zero], -1)], -1)
    return F.pad(feats, (0, OBS_DIM - feats.shape[-1]))


def _grid_obs(loss, round_idx, good_frac, *, loss_max: float,
              horizon: float) -> torch.Tensor:
    """`deploy_obs` at grid points (float32 tensors of one shape), with
    the queue, tau and frequency at their neutral values (the
    distillation marginal)."""
    loss, round_idx, good_frac = torch.broadcast_tensors(loss, round_idx,
                                                         good_frac)
    rest = (1.0 - good_frac) * 0.5
    ch3 = torch.stack([good_frac, rest, rest], -1)
    return deploy_obs(loss, torch.zeros_like(loss), round_idx / horizon,
                      torch.tanh(loss),
                      torch.remainder(round_idx.to(torch.int32), 10), ch3,
                      torch.ones_like(loss), loss_max=loss_max)


def distill_table(eval_params, *, loss_bins: int = 24, round_bins: int = 16,
                  good_bins: int = 8, loss_max: float = 2.3,
                  horizon: float = 100.0) -> PolicyTable:
    """Evaluate the trained net over a feature grid and freeze the argmax,
    the whole (L, R, G, OBS_DIM) grid in one batched forward pass."""
    dev = next(iter(eval_params.values())).device
    # (the grids may differ from ``jnp.linspace``'s by an ulp)
    lin = lambda stop, n: torch.linspace(0.0, stop, n, device=dev)
    loss_grid, round_grid, good_grid = (lin(loss_max, loss_bins),
                                        lin(horizon, round_bins),
                                        lin(1.0, good_bins))
    obs = _grid_obs(loss_grid[:, None, None], round_grid[None, :, None],
                    good_grid[None, None, :], loss_max=loss_max,
                    horizon=horizon)                   # (L, R, G, OBS_DIM)
    q = q_values(eval_params, obs)                     # (L, R, G, n)
    table = torch.argmax(q, dim=-1).to(torch.int32) + 1
    return PolicyTable(table=table, loss_grid=loss_grid,
                       round_grid=round_grid, good_grid=good_grid)


def _nearest(grid: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    mids = 0.5 * (grid[1:] + grid[:-1])
    return torch.clamp(torch.searchsorted(mids, x.reshape(1)), 0,
                       grid.shape[0] - 1)[0]


def table_policy(table: PolicyTable) -> ScanPolicy:
    def step(state, obs: CtlObs):
        i = _nearest(table.loss_grid, obs.cluster_loss)
        j = _nearest(table.round_grid, obs.round.to(torch.float32))
        k = _nearest(table.good_grid, obs.channel_good_frac)
        return table.table[i, j, k], state

    return ScanPolicy(state=(), step=step, needs_obs=False)
