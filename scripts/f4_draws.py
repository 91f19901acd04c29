"""Fig 5's energies of the port on the JAX package's random numbers (CPU).

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/f4_draws.py [--offset 0]

Fig 5 trains a DQN agent for 1 and for 6 episodes of the DT environment
at each channel (p_good 0.9, 0.5, 0.1; seed 3 + offset) and measures the
energy a greedy rollout spends to reach the loss target (reset key 7 +
offset).  The port's `fig5_energy_by_channel` draws its own numbers; this
script runs the JAX package's protocol (``benchmarks/common.py``'s
``train_dqn_agent``, ``benchmarks/figures.py``'s ``_greedy_rollout``) and,
beside it, the port's Alg.-1 transition (`control.scanned_dqn
._transition`) and environment on the same numbers: the JAX package's
initial network, its epsilon-greedy uniforms and random actions, its
replay rows, its environment's reset and step draws (the channel path
mapped to the uniforms that give it, as ``tests/test_torch_dqn.py``
does).  Prints, a channel, the early and trained energies of both
packages, each episode's actions where they first differ, and the
largest difference of the trained networks' weights.  Needs JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from benchmarks import figures as jfigures  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.core import envs as jenvs  # noqa: E402
from repro.core.energy import NOISE_MEAN_DB  # noqa: E402
from repro_torch.control.scanned_dqn import (EpCarry,  # noqa: E402
                                              EpisodeDraws, _transition)
from repro_torch.core import dqn as tdqn  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import envs as tenvs  # noqa: E402

CHANNELS = (("good", 0.9), ("medium", 0.5), ("bad", 0.1))


def channel_uniforms(prev, nxt, p_good):
    """Uniforms that the port's channel step maps from ``prev`` to
    ``nxt``: the middle of each next state's interval."""
    cdf = tenergy.channel_cdf(p_good).numpy().astype(np.float64)
    prev, nxt = np.asarray(prev), np.asarray(nxt)
    hi = cdf[prev, nxt]
    lo = np.where(nxt > 0, cdf[prev, np.maximum(nxt - 1, 0)], 0.0)
    return torch.tensor((lo + hi) / 2, dtype=torch.float32)


def port_agent(js):
    """The port's agent from the JAX package's."""
    rep = js.replay
    t = lambda a, dt=torch.float32: torch.as_tensor(np.array(a), dtype=dt)
    return tdqn.DQNState(
        eval_params=tdqn.dqn_params_from_numpy(js.eval_params),
        target_params=tdqn.dqn_params_from_numpy(js.target_params),
        replay=tdqn.Replay(s=t(rep.s), a=t(rep.a, torch.int64), r=t(rep.r),
                           s2=t(rep.s2), ptr=t(rep.ptr, torch.int64),
                           full=t(rep.full, torch.bool)),
        step=t(js.step, torch.int64))


def port_params(p):
    return tenvs.EnvParams(**{**p._asdict(),
                              "channel": tenergy.ChannelParams()})


def reset_both(key, p):
    """The JAX package's reset and the port's, on its draws."""
    js, jobs = jenvs.reset(key, p)
    _, kd, _, _ = jax.random.split(key, 4)
    draws = tenvs.ResetDraws(
        freq=torch.from_numpy(np.array(js.twins.freq)),
        data_size=torch.from_numpy(np.array(js.twins.data_size)),
        deviation=torch.from_numpy(np.array(jax.random.uniform(
            kd, (p.n_devices,), minval=0.0, maxval=0.2))),
        channel_u=channel_uniforms(np.zeros(p.n_devices, int), js.channel,
                                   p.p_good))
    ts, tobs = tenvs.reset(port_params(p), draws)
    return js, jobs, ts, tobs


def step_draws(js, js_next, p):
    """The port's `StepDraws` of the JAX package's step from ``js`` to
    ``js_next``."""
    _, _, kn, ke = jax.random.split(js.key, 4)
    return tenvs.StepDraws(
        loss_noise=torch.tensor(float(jax.random.normal(kn, ()))),
        comm_noise=torch.from_numpy(np.array(jax.random.poisson(
            ke, NOISE_MEAN_DB[js.channel], js.channel.shape)).astype(
                np.float32)),
        channel_u=channel_uniforms(js.channel, js_next.channel, p.p_good))


def train_both(episodes, p_good, seed, horizon=30):
    """``benchmarks/common.train_dqn_agent`` and the port's transitions on
    its numbers -> (JAX agent, port agent, per-episode actions of each)."""
    p = jenvs.EnvParams(horizon=horizon, p_good=p_good, calibrate_dt=True)
    dcfg = jcore.DQNConfig(buffer_size=1024, batch_size=32, lr=2e-3)
    tcfg = tdqn.DQNConfig(**{f: getattr(dcfg, f)
                             for f in dcfg._fields})
    jag = jcore.init_dqn(jax.random.PRNGKey(seed), dcfg)
    tag = port_agent(jag)
    key = jax.random.PRNGKey(seed + 1)
    step_env = jax.jit(jenvs.step, static_argnums=2)
    acts = []
    for ep in range(episodes):
        js, jobs, ts, tobs = reset_both(jax.random.fold_in(key, ep), p)
        carry = EpCarry(env=ts, obs=tobs, done=torch.zeros((), dtype=bool),
                        agent=tag, ret=torch.zeros(()))
        done, ja, ta = False, [], []
        while not done:
            key, ka, kt = jax.random.split(key, 3)
            kg, kr = jax.random.split(ka)
            a = jcore.select_action(ka, jag, dcfg, jobs)
            js2, jobs2, r, done, _ = step_env(js, a, p)
            rep = jag.replay
            jag = jcore.store(jag, jobs, a, r, jobs2)
            rep = jag.replay
            limit = int(jnp.where(rep.full, rep.s.shape[0],
                                  jnp.maximum(rep.ptr, 1)))
            idx = np.array(jax.random.randint(kt, (dcfg.batch_size,), 0,
                                              limit))
            jag, _ = jcore.dqn_train_step(kt, jag, dcfg)
            draws = EpisodeDraws(
                u_greedy=torch.tensor(float(jax.random.uniform(kg))),
                rand_action=torch.tensor(int(jax.random.randint(
                    kr, (), 0, dcfg.n_actions))),
                env=step_draws(js, js2, p),
                replay_u=torch.from_numpy((idx + 0.5) / limit).to(
                    torch.float32))
            carry, _, _ = _transition(carry, tcfg, port_params(p), draws)
            ja.append(int(a))
            ta.append(int(carry.agent.replay.a[(int(
                carry.agent.replay.ptr) - 1) % dcfg.buffer_size]))
            js, jobs = js2, jobs2
            done = bool(done)
        tag = carry.agent
        acts.append({"jax": ja, "port": ta,
                     "port_done_with_jax": bool(carry.done)})
    return jag, tag, acts


def rollout_both(jag, tag, p_good, key, loss_target=0.35, max_steps=200):
    """``benchmarks/figures._greedy_rollout`` and the port's greedy policy
    on its numbers -> (JAX energy, port energy, both actions)."""
    p = jenvs.EnvParams(p_good=p_good)._replace(budget=1e9,
                                                horizon=max_steps)
    tp = port_params(p)
    js, jobs, ts, tobs = reset_both(key, p)
    step_env = jax.jit(jenvs.step, static_argnums=2)
    ej = et = 0.0
    ja, ta = [], []
    jdone = tdone = False
    steps = 0
    while steps < max_steps and not (jdone and tdone):
        js2, jobs2, _, _, jinfo = step_env(
            js, jnp.argmax(jcore.q_values(jag.eval_params, jobs)), p)
        if not jdone:
            ej += float(jinfo["consumed"])
            ja.append(int(jnp.argmax(jcore.q_values(jag.eval_params, jobs))))
            jdone = float(js2.loss) <= loss_target
        if not tdone:
            a = torch.argmax(tdqn.q_values(tag.eval_params, tobs))
            ts, tobs, _, _, tinfo = tenvs.step(ts, a, tp,
                                               step_draws(js, js2, p))
            et += float(tinfo["consumed"])
            ta.append(int(a))
            tdone = float(ts.loss) <= loss_target
        js, jobs = js2, jobs2
        steps += 1
    return ej, et, ja, ta


def first_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def main(offset: int, episodes: int) -> dict:
    out = {}
    for label, p_good in CHANNELS:
        row = {}
        for name, eps in (("early", 1), ("trained", episodes)):
            jag, tag, acts = train_both(eps, p_good, 3 + offset)
            ej, et, ja, ta = rollout_both(jag, tag, p_good,
                                          jax.random.PRNGKey(7 + offset))
            wdiff = max(float(np.abs(np.array(jag.eval_params[k])
                                     - tag.eval_params[k].numpy()).max())
                        for k in jag.eval_params)
            row[name] = {
                "jax_energy": ej, "port_energy_on_jax_draws": et,
                "rollout_steps": [len(ja), len(ta)],
                "rollout_first_difference": first_difference(ja, ta),
                "train_first_difference": [
                    first_difference(a["jax"], a["port"]) for a in acts],
                "weights_max_abs_diff": wdiff}
        out[label] = row
        print(json.dumps({label: row}), flush=True)
    # the JAX package's own fig5 at this offset, for the record
    if offset == 0:
        out["jax_fig5"] = {k: list(v) for k, v in
                           jfigures.fig5_energy_by_channel(episodes).items()}
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--offset", type=int, default=0)
    ap.add_argument("--episodes", type=int, default=6)
    args = ap.parse_args()
    print(json.dumps(main(args.offset, args.episodes)), flush=True)
