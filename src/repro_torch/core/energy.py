"""Energy and channel models (paper §III-D, Eqns 7-8).

Compute energy per local training (Eqn 7):   E_cmp = n_cmp * F / f_i
OFDMA uplink communication energy (Eqn 8):
    E_com = n_com * M / sum_c l_{i,c} W log2(1 + p h / I)

The wireless channel is a finite-state Markov channel over {good, medium,
bad} with Poisson noise of mean {0.1, 0.3, 0.5} dB (paper §V).  The random
functions take their draws as arguments: `channel_rate` the per-member
Poisson noise counts, `step_channel` one uniform per device.  The port's
engine draws both with `repro_torch.rng`; the parity tests hand over the
JAX package's draws.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch import rng

GOOD, MEDIUM, BAD = 0, 1, 2
NOISE_MEAN_DB = (0.1, 0.3, 0.5)


class ChannelParams(NamedTuple):
    bandwidth: float = 1e5          # W: sub-channel bandwidth [Hz]
    n_subchannels: int = 8          # |C|
    tx_power: float = 0.2           # p_{i,c} [W]
    gain: float = 1.0               # h_{i,c}
    model_bits: float = 8e6         # M: model size [bits]
    n_com: float = 1.0              # comm normalization factor
    n_cmp: float = 1.0              # compute normalization factor
    train_cycles: float = 1.0       # F: CPU cycles for one local training [G]


def compute_energy(freq, params: ChannelParams = ChannelParams()):
    """Eqn 7 per local training, vectorized over clients. freq: (n,) [GHz]."""
    return params.n_cmp * params.train_cycles / torch.clamp(freq, min=1e-3)


def noise_mean(state: torch.Tensor) -> torch.Tensor:
    """The Poisson mean [dB] of each channel state (scalars, not a table,
    so no host-to-device copy per round)."""
    good, medium, bad = NOISE_MEAN_DB
    return torch.where(state == GOOD, good,
                       torch.where(state == MEDIUM, medium, bad)).to(
                           torch.float32)


@functools.lru_cache(maxsize=None)
def _noise_cdf(device: torch.device) -> torch.Tensor:
    return rng.poisson_cdf_table(NOISE_MEAN_DB).to(device)


def draw_noise(u: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Poisson(NOISE_MEAN_DB[state]) counts from uniforms ``u``, by
    inversion of the distribution function."""
    return rng.inverse_cdf(u, _noise_cdf(state.device)[state]).to(
        torch.float32)


def channel_rate(state, noise, params: ChannelParams = ChannelParams()):
    """Shannon rate per client given channel state (n,) in {0,1,2} and the
    drawn Poisson noise counts (n,)."""
    noise_db = noise.to(torch.float32) + noise_mean(state)
    noise = 10.0 ** (noise_db / 10.0) * 1e-7
    snr = params.tx_power * params.gain / noise
    frac = 1.0 / params.n_subchannels
    return params.n_subchannels * frac * params.bandwidth * torch.log2(
        1.0 + snr)


def comm_energy(state, noise, params: ChannelParams = ChannelParams()):
    """Eqn 8 per aggregation upload, vectorized over clients."""
    rate = channel_rate(state, noise, params)
    return params.n_com * params.model_bits / torch.clamp(rate, min=1.0)


def round_energy(a, true_freq, channel_state, noise,
                 params: ChannelParams = ChannelParams()):
    """Eqns 7+8 for one cluster round: ``a`` local trainings plus one
    upload per member.  ``true_freq`` is the device's real frequency
    f + f̂; ``noise`` the members' drawn channel-noise counts."""
    e_cmp = a * compute_energy(true_freq, params)
    e_com = comm_energy(channel_state, noise, params)
    return e_cmp + e_com


def _transition_rows(p_good: float):
    rest = (1.0 - p_good) / 2.0
    return [[p_good, rest, rest]] * 3


def channel_transition(p_good: float) -> torch.Tensor:
    """3-state transition matrix parameterized by the stationary
    probability of the good state."""
    return torch.tensor(_transition_rows(p_good), dtype=torch.float32)


def channel_cdf(p_good: float) -> torch.Tensor:
    """Row-wise distribution functions of `channel_transition`, summed in
    float64 on the host, for `step_channel`."""
    return rng.cdf_table(_transition_rows(p_good))


def step_channel(u: torch.Tensor, state: torch.Tensor, cdf: torch.Tensor
                 ) -> torch.Tensor:
    """Next channel state of every device: inverse CDF of its transition
    row at uniform ``u``; ``cdf`` is `channel_cdf` on ``state``'s
    device."""
    return rng.inverse_cdf(u, cdf[state])
