"""DT-simulated federated-learning environment for DQN training (paper §IV).

The paper's systems claim: the DRL agent interacts with the digital twins,
not the physical devices (§IV-C).  This module is that surrogate, an MDP
whose dynamics come from the twin state: a loss-decay curve with a
diminishing aggregation gain, Eqn-7/8 energy and the Markov channel.

Observation layout (``OBS_DIM`` = 48, the paper's 48 x 200 x 10 net):
    [ loss, dloss, queue, round_frac, budget_frac,
      onehot(last_action, 10), channel_fracs(3), mean_freq, mean_dev,
      tau (mean hidden activation proxy), pad... ]

`reset` and `step` take their draws as arguments (`ResetDraws`,
`StepDraws`); `draw_reset` and `draw_step` make them with
`repro_torch.rng`, keyed by (seed, episode, step), so they are the same on
the CPU and on the card.  The parity tests hand over the JAX package's.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import rng

from .energy import (ChannelParams, channel_cdf, comm_energy,
                     compute_energy, draw_noise, step_channel)
from .lyapunov import v_schedule
from .twin import (TwinState, calibrate, calibrated_freq, init_twins,
                   sample_deviation)

OBS_DIM = 48
N_ACTIONS = 10


class EnvParams(NamedTuple):
    n_devices: int = 16
    horizon: int = 100              # k: planned aggregation rounds
    budget: float = 250.0           # beta * R_m (E_com ~ E_cmp regime)
    p_good: float = 0.5             # stationary good-channel probability
    kappa: float = 0.08             # loss-decay rate per local step
    f_star: float = 0.1             # asymptotic loss
    f0: float = 2.3                 # initial loss (ln 10)
    v0: float = 1.0
    v_growth: float = 0.02
    noise: float = 0.01
    reward_scale: float = 0.02      # keeps Q-values O(1) for stable TD
    calibrate_dt: bool = True       # False => Fig-3 "with DT deviation" arm
    channel: ChannelParams = ChannelParams()


class EnvState(NamedTuple):
    twins: TwinState
    loss: torch.Tensor              # () global loss F(w)
    queue: torch.Tensor             # () deficit queue Q(i)
    spent: torch.Tensor             # () cumulative resource use
    round: torch.Tensor             # () int64
    channel: torch.Tensor           # (n,) int64 per-device channel state
    last_action: torch.Tensor       # () int64


class ResetDraws(NamedTuple):
    freq: torch.Tensor              # (n,) mapped frequencies ~ U(0.5, 2)
    data_size: torch.Tensor         # (n,) dataset sizes in [256, 4096)
    deviation: torch.Tensor         # (n,) DT mapping error ~ U(0, 0.2)
    channel_u: torch.Tensor         # (n,) uniforms of the first channel


class StepDraws(NamedTuple):
    loss_noise: torch.Tensor        # () standard normal
    comm_noise: torch.Tensor        # (n,) Poisson channel-noise counts
    channel_u: torch.Tensor         # (n,) uniforms of the next channel


@functools.lru_cache(maxsize=None)
def _transition_cdf(p_good: float, device: torch.device) -> torch.Tensor:
    """`channel_cdf` on ``device``, copied there once."""
    return channel_cdf(p_good).to(device)


def _obs(p: EnvParams, s: EnvState) -> torch.Tensor:
    one = lambda v: v.reshape(1).to(torch.float32)
    feats = torch.cat([
        one(s.loss), one(p.f0 - s.loss), one(s.queue),
        one(s.round / p.horizon), one(s.spent / p.budget),
        F.one_hot(s.last_action, N_ACTIONS).to(torch.float32),
        F.one_hot(s.channel, 3).to(torch.float32).mean(0),
        one(calibrated_freq(s.twins).mean()),
        one((s.twins.freq_dev - s.twins.dev_estimate).abs().mean()),
        one(torch.tanh(s.loss)),          # tau: mean-activation proxy
    ])
    return F.pad(feats, (0, OBS_DIM - feats.shape[0]))


def reset(p: EnvParams, draws: ResetDraws):
    """A fresh episode from its draws: (state, obs).  The twins start with
    an infinite loss, as the JAX package's do."""
    dev = draws.freq.device
    twins = sample_deviation(init_twins(draws.freq, draws.data_size),
                             draws.deviation)
    channel = step_channel(
        draws.channel_u, torch.zeros((p.n_devices,), dtype=torch.int64,
                                     device=dev),
        _transition_cdf(p.p_good, dev))
    z = torch.zeros((), device=dev)
    zi = torch.zeros((), dtype=torch.int64, device=dev)
    s = EnvState(twins=twins, loss=torch.full((), p.f0, device=dev),
                 queue=z, spent=z, round=zi, channel=channel,
                 last_action=zi)
    return s, _obs(p, s)


def step(s: EnvState, action: torch.Tensor, p: EnvParams,
         draws: StepDraws):
    """``action`` in [0, N_ACTIONS): a_i = action + 1 local steps this
    round.  Returns (state', obs, reward, done, info)."""
    a = action.to(torch.float32) + 1.0
    twins = s.twins

    # --- energy (Eqns 7-8); DT deviation biases the *estimated* compute term
    freq_true = twins.freq + twins.freq_dev
    freq_est = calibrated_freq(twins) if p.calibrate_dt else twins.freq
    e_cmp = compute_energy(freq_true, p.channel).mean()
    e_cmp_est = compute_energy(freq_est, p.channel).mean()
    e_com = comm_energy(s.channel, draws.comm_noise, p.channel).mean()
    consumed = a * e_cmp + e_com
    estimated = a * e_cmp_est + e_com

    # --- loss decay with a non-linear (diminishing) aggregation gain
    decay = torch.exp(-p.kappa * a
                      / (1.0 + 0.05 * s.round.to(torch.float32)))
    mis_est = (e_cmp_est - e_cmp).abs() / torch.clamp(e_cmp, min=1e-6)
    noise = p.noise * draws.loss_noise * (1.0 + 5.0 * mis_est)
    new_loss = torch.clamp(p.f_star + (s.loss - p.f_star) * decay + noise,
                           min=0.0)

    # --- Lyapunov deficit queue (Eqn 12)
    queue = torch.clamp(s.queue + consumed - p.budget / p.horizon, min=0.0)

    # --- reward (Eqn 15) from the DT-*estimated* cost
    v = v_schedule(s.round, p.v0, p.v_growth)
    reward = (v * (s.loss - new_loss) - s.queue * estimated) * p.reward_scale

    channel = step_channel(draws.channel_u, s.channel,
                           _transition_cdf(p.p_good, s.channel.device))
    twins = twins.replace(loss=new_loss.expand(twins.loss.shape).contiguous())
    if p.calibrate_dt:
        twins = calibrate(twins)
    ns = EnvState(twins=twins, loss=new_loss, queue=queue,
                  spent=s.spent + consumed, round=s.round + 1,
                  channel=channel, last_action=action.to(torch.int64))
    done = (ns.round >= p.horizon) | (ns.spent >= p.budget)
    info = {"consumed": consumed, "e_com": e_com, "e_cmp": e_cmp,
            "queue": queue,
            "good_frac": (s.channel == 0).to(torch.float32).mean()}
    return ns, _obs(p, ns), reward, done, info


def draw_reset(seed: int, episode: int, p: EnvParams, device
               ) -> ResetDraws:
    """An episode's reset draws, keyed by (seed, episode)."""
    n = p.n_devices
    u = rng.uniform(seed, episode, rng.ENV_RESET,
                    torch.zeros((), dtype=torch.int64, device=device),
                    torch.arange(4 * n, device=device)).reshape(4, n)
    return ResetDraws(
        freq=0.5 + 1.5 * u[0],
        data_size=(256 + rng.randint(u[1], torch.full(
            (), 4096 - 256, dtype=torch.int64, device=device))).to(
                torch.float32),
        deviation=0.2 * u[2], channel_u=u[3])


def draw_step(u: torch.Tensor, channel: torch.Tensor) -> StepDraws:
    """A step's environment draws from 2 + 2n uniforms ``u``; ``channel``
    is the current channel state, whose noise means the Poisson counts
    take."""
    n = channel.shape[0]
    return StepDraws(loss_noise=rng.normal(u[0], u[1]),
                     comm_noise=draw_noise(u[2:2 + n], channel),
                     channel_u=u[2 + n:2 + 2 * n])
