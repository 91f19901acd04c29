"""Alg. 1 (DQN on the DT-simulated environment) as a fixed-length loop on
the device.

`train_on_env` runs ``episodes`` episodes of exactly ``p.horizon`` steps
each.  An episode that ends early (its budget spent) *freezes* its carry:
every later step computes as usual and then selects the old carry with
``torch.where`` on the device's ``done`` flag, so the steps past the
terminal transition are no-ops on exactly the state a host loop would
have stopped at, and the loop reads nothing back to the host until the
caller reads ``aux``.  (The JAX package's nested ``lax.scan`` freezes its
carry the same way.)

Each step's draws are a function of (seed, episode, the env's round
counter) through `repro_torch.rng`; the round counter is part of the
frozen carry, so a frozen step draws nothing new that a later step could
miss.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import rng
from repro_torch.core import dqn as dqn_lib
from repro_torch.core import envs

__all__ = ["train_on_env", "episode_step", "EpisodeDraws", "draw_episode"]


class EpCarry(NamedTuple):
    env: envs.EnvState
    obs: torch.Tensor           # (OBS_DIM,) f32
    done: torch.Tensor          # () bool: episode already terminated
    agent: dqn_lib.DQNState
    ret: torch.Tensor           # () f32 undiscounted episode return


class EpisodeDraws(NamedTuple):
    """The random numbers of one Alg.-1 transition."""
    u_greedy: torch.Tensor      # () uniform against epsilon
    rand_action: torch.Tensor   # () int64 action when not greedy
    env: envs.StepDraws
    replay_u: torch.Tensor      # (batch_size,) uniforms of replay rows


def _freeze(done: torch.Tensor, new, old):
    """``old`` wherever the episode has already terminated, leaf by leaf."""
    if torch.is_tensor(new):
        return torch.where(done, old, new)
    if isinstance(new, dict):
        return {k: _freeze(done, new[k], old[k]) for k in new}
    if dataclasses.is_dataclass(new):
        return type(new)(**{f.name: _freeze(done, getattr(new, f.name),
                                            getattr(old, f.name))
                            for f in dataclasses.fields(new)})
    return type(new)._make(_freeze(done, n, o) for n, o in zip(new, old))


def draw_episode(seed: int, episode: int, carry: EpCarry,
                 cfg: dqn_lib.DQNConfig, p: envs.EnvParams) -> EpisodeDraws:
    """One transition's draws, keyed by (seed, episode, the env's round)."""
    n, dev = p.n_devices, carry.obs.device
    u = rng.uniform(seed, episode, rng.DQN_STEP, carry.env.round,
                    torch.arange(2 + 2 * (1 + n) + cfg.batch_size,
                                 device=dev))
    k = 2 + 2 * (1 + n)
    n_act = torch.full((), cfg.n_actions, dtype=torch.int64, device=dev)
    return EpisodeDraws(
        u_greedy=u[0], rand_action=rng.randint(u[1], n_act),
        env=envs.draw_step(u[2:k], carry.env.channel), replay_u=u[k:])


def _transition(carry: EpCarry, cfg: dqn_lib.DQNConfig,
                p: envs.EnvParams, draws: EpisodeDraws):
    """`episode_step`, plus the step's TD loss and consumed energy (0 for
    a step past the episode's end)."""
    a = dqn_lib.select_action(carry.agent, cfg, carry.obs, draws.u_greedy,
                              draws.rand_action)
    env, obs2, r, done2, info = envs.step(carry.env, a, p, draws.env)
    agent = dqn_lib.store(carry.agent, carry.obs, a, r, obs2)
    idx = rng.randint(draws.replay_u, dqn_lib.replay_limit(agent.replay))
    agent, td = dqn_lib.train_step(agent, cfg, idx)
    new = EpCarry(env=env, obs=obs2, done=carry.done | done2, agent=agent,
                  ret=carry.ret + r)
    zero = torch.zeros((), device=td.device)
    return (_freeze(carry.done, new, carry),
            torch.where(carry.done, zero, td),
            torch.where(carry.done, zero, info["consumed"]))


def episode_step(carry: EpCarry, cfg: dqn_lib.DQNConfig,
                 p: envs.EnvParams, draws: EpisodeDraws) -> EpCarry:
    """One Alg.-1 transition: epsilon-greedy select, env step, replay
    store, TD train on replay rows drawn over the buffer as the store left
    it; a no-op once the episode is done."""
    return _transition(carry, cfg, p, draws)[0]


def train_on_env(agent: dqn_lib.DQNState, cfg: dqn_lib.DQNConfig,
                 p: envs.EnvParams, *, episodes: int, seed: int = 0):
    """Train ``agent`` for ``episodes`` episodes of the DT environment
    (Alg. 1) on its device.  Returns ``(agent, aux)`` with ``aux =
    {"ep_return": (episodes,) f32, "ep_len": (episodes,) int64,
    "td_loss": (episodes, horizon) f32, "consumed": (episodes, horizon)
    f32}``, tensors on the agent's device: each step's TD loss and
    consumed energy, 0 past the episode's end (step ``t`` of episode ``e``
    ran if ``t < ep_len[e]``)."""
    dev = agent.step.device
    rets, lens, tds, used = [], [], [], []
    for ep in range(int(episodes)):
        env, obs = envs.reset(p, envs.draw_reset(seed, ep, p, dev))
        carry = EpCarry(env=env, obs=obs,
                        done=torch.zeros((), dtype=torch.bool, device=dev),
                        agent=agent, ret=torch.zeros((), device=dev))
        for _ in range(p.horizon):
            carry, td, consumed = _transition(
                carry, cfg, p, draw_episode(seed, ep, carry, cfg, p))
            tds.append(td)
            used.append(consumed)
        agent = carry.agent
        rets.append(carry.ret)
        lens.append(torch.where(carry.done, carry.env.round, p.horizon))
    shape = (int(episodes), p.horizon)
    return agent, {"ep_return": torch.stack(rets),
                   "ep_len": torch.stack(lens),
                   "td_loss": torch.stack(tds).reshape(shape),
                   "consumed": torch.stack(used).reshape(shape)}
