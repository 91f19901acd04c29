"""DQN for adaptive aggregation-frequency calibration (paper §IV-B/C, Alg. 1).

Two identical fully-connected networks (eval_net O and target_net O'),
48 x 200 x 200 x 10 by default, experience replay in a ring buffer,
epsilon-greedy selection with a growing greed coefficient, a periodic
target sync and the TD loss of Eqns 16-18 minimised by SGD.

Actions index the number of local updates a_i in {1..n_actions} between
global aggregations.  Every tensor of a `DQNState` lives on one device, and
nothing here reads a value back to the host.  The random functions take
their draws as arguments (`select_action` a uniform and a random action,
`train_step` the replay indices): `repro_torch.control.scanned_dqn` draws
them with `repro_torch.rng`, the parity tests hand over the JAX package's.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class DQNConfig(NamedTuple):
    state_dim: int = 48
    hidden: int = 200
    n_actions: int = 10
    gamma: float = 0.9            # attenuation coefficient (paper §IV-B)
    lr: float = 1e-3
    buffer_size: int = 2048
    batch_size: int = 64
    target_sync: int = 50         # F_u: target_net update frequency
    eps0: float = 0.1             # initial greed coefficient
    eps_growth: float = 1e-3      # r: greed growth rate per step (-> 1.0)


class Replay(NamedTuple):
    s: torch.Tensor       # (cap, state_dim) f32
    a: torch.Tensor       # (cap,) int64
    r: torch.Tensor       # (cap,) f32
    s2: torch.Tensor      # (cap, state_dim) f32
    ptr: torch.Tensor     # () int64 next slot
    full: torch.Tensor    # () bool: every slot written at least once


class DQNState(NamedTuple):
    eval_params: Params
    target_params: Params
    replay: Replay
    step: torch.Tensor    # () int64 TD steps taken


def _init_net(generator: torch.Generator, cfg: DQNConfig) -> Params:
    """Gaussian weights scaled by 1/sqrt(fan_in), zero biases (the JAX
    package's scheme), drawn on the CPU."""
    n = lambda *shape: torch.randn(shape, generator=generator)
    return {
        "w1": n(cfg.state_dim, cfg.hidden) / math.sqrt(cfg.state_dim),
        "b1": torch.zeros((cfg.hidden,)),
        "w2": n(cfg.hidden, cfg.hidden) / math.sqrt(cfg.hidden),
        "b2": torch.zeros((cfg.hidden,)),
        "w3": n(cfg.hidden, cfg.n_actions) / math.sqrt(cfg.hidden),
        "b3": torch.zeros((cfg.n_actions,)),
    }


def q_values(params: Params, s: torch.Tensor) -> torch.Tensor:
    """Three fully-connected layers (paper §V network), over any leading
    dims of ``s``."""
    h = torch.relu(s @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return h @ params["w3"] + params["b3"]


def init_dqn(generator: torch.Generator, cfg: DQNConfig,
             device="cpu") -> DQNState:
    """A fresh agent on ``device``: eval net from ``generator``, the target
    net a copy of it, an empty replay buffer."""
    eval_p = {k: v.to(device) for k, v in _init_net(generator, cfg).items()}
    cap, d = cfg.buffer_size, cfg.state_dim
    z = lambda *shape, dtype=torch.float32: torch.zeros(
        shape, dtype=dtype, device=device)
    return DQNState(eval_params=eval_p,
                    target_params={k: v.clone() for k, v in eval_p.items()},
                    replay=Replay(s=z(cap, d), a=z(cap, dtype=torch.int64),
                                  r=z(cap), s2=z(cap, d),
                                  ptr=z(dtype=torch.int64),
                                  full=z(dtype=torch.bool)),
                    step=z(dtype=torch.int64))


def dqn_params_from_numpy(params, device="cpu") -> Params:
    """The port's network parameters from the JAX package's (leaves as
    numpy arrays, or anything ``np.asarray`` takes)."""
    return {k: torch.as_tensor(np.array(v), dtype=torch.float32,
                               device=device) for k, v in params.items()}


def epsilon(cfg: DQNConfig, step: torch.Tensor) -> torch.Tensor:
    """Greed coefficient: grows from eps0 toward 1 at rate r (Alg. 1)."""
    return torch.clamp(cfg.eps0 + cfg.eps_growth * step.to(torch.float32),
                       max=1.0)


def select_action(state: DQNState, cfg: DQNConfig, s: torch.Tensor,
                  u_greedy: torch.Tensor, rand_action: torch.Tensor
                  ) -> torch.Tensor:
    """Epsilon-greedy (Alg. 1 line 5): the greedy action when the uniform
    ``u_greedy`` falls below epsilon, ``rand_action`` otherwise.  Ties in
    the argmax go to the first action, as ``jnp.argmax`` breaks them."""
    greedy = torch.argmax(q_values(state.eval_params, s))
    use_greedy = u_greedy < epsilon(cfg, state.step)
    return torch.where(use_greedy, greedy, rand_action.to(torch.int64))


def store(state: DQNState, s, a, r, s2) -> DQNState:
    """Write one transition at the ring buffer's pointer and advance it."""
    rep = state.replay
    cap = rep.s.shape[0]
    i = rep.ptr.reshape(1)
    put = lambda buf, v: buf.index_copy(0, i, v.reshape(
        (1,) + tuple(buf.shape[1:])).to(buf.dtype))
    rep = Replay(s=put(rep.s, s), a=put(rep.a, a), r=put(rep.r, r),
                 s2=put(rep.s2, s2), ptr=(rep.ptr + 1) % cap,
                 full=rep.full | (rep.ptr + 1 >= cap))
    return state._replace(replay=rep)


def replay_limit(replay: Replay) -> torch.Tensor:
    """How many slots a replay draw may index: every slot once the buffer
    has wrapped, else the ones written (at least 1)."""
    return torch.where(replay.full, replay.s.shape[0],
                       torch.clamp(replay.ptr, min=1))


def td_loss(eval_params: Params, target_params: Params, cfg: DQNConfig,
            batch) -> torch.Tensor:
    """Eqn 16 over a replay batch, with the Eqn-17 target from the target
    net, outside the gradient."""
    s, a, r, s2 = batch
    q_sa = torch.gather(q_values(eval_params, s), 1, a[:, None])[:, 0]
    with torch.no_grad():
        y = r + cfg.gamma * q_values(target_params, s2).max(dim=1).values
    return torch.mean((y - q_sa) ** 2)


def train_step(state: DQNState, cfg: DQNConfig, idx: torch.Tensor):
    """One Alg.-1 learning iteration on the replay rows ``idx``: the TD
    loss, its gradient by autograd, a clip of the global gradient norm to
    5 (TD targets can spike when the deficit queue builds up), an SGD step
    (Eqn 18), and the target sync when the step count *before* this step
    is a multiple of ``target_sync``.  Returns (state, loss)."""
    rep = state.replay
    batch = (rep.s[idx], rep.a[idx], rep.r[idx], rep.s2[idx])
    keys = sorted(state.eval_params)
    p = {k: state.eval_params[k].detach().requires_grad_(True) for k in keys}
    with torch.enable_grad():
        loss = td_loss(p, state.target_params, cfg, batch)
        grads = torch.autograd.grad(loss, [p[k] for k in keys])
    gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = torch.clamp(5.0 / (gnorm + 1e-9), max=1.0)
    eval_p = {k: (p[k] - cfg.lr * scale * g).detach()
              for k, g in zip(keys, grads)}
    sync = (state.step % cfg.target_sync) == 0
    target_p = {k: torch.where(sync, eval_p[k], state.target_params[k])
                for k in keys}
    return state._replace(eval_params=eval_p, target_params=target_p,
                          step=state.step + 1), loss.detach()
