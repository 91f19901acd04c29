"""The paper's Figs 2-8 on the synthetic MNIST-shaped task, on the port.

Each ``fig*`` function prints ``name,metric,value`` CSV rows and returns a
dict, as the JAX package's ``benchmarks/figures.py`` does, at the same
protocol: the same fleet sizes, widths, data sizes, simulated budgets and
seeds.  ``seed`` (0 by default) is added to every seed of a protocol, so
that a sweep over seeds is possible; ``device`` is the card unless the
caller asks for another.  `repro_torch.paper.__main__` drives them all.

  fig2  DQN convergence (TD loss over training)
  fig3  accuracy with DT-deviation calibration against without
  fig4  aggregation count against the channel-state distribution
  fig5  energy consumed against channel state over DQN training
  fig6  accuracy against time for cluster counts (straggler elimination)
  fig7  time-to-accuracy against cluster count
  fig8  adaptive (DQN) against fixed aggregation frequency accuracy
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import core, rng
from repro_torch.core import envs

from .common import fed_setup, train_dqn_agent


def fig2_dqn_convergence(episodes=8, *, seed=0, device=None):
    out = train_dqn_agent(episodes=episodes, seed=seed, device=device)
    l = np.asarray(out["td_losses"])
    k = max(1, len(l) // 20)
    smooth = np.convolve(l, np.ones(k) / k, mode="valid")
    early, late = float(smooth[:k].mean()), float(smooth[-k:].mean())
    print(f"fig2,td_loss_early,{early:.4f}")
    print(f"fig2,td_loss_late,{late:.4f}")
    print(f"fig2,converged,{int(late < early)}")
    return dict(early=early, late=late, losses=l.tolist()[:200])


def fig3_dt_deviation(sim_seconds=10.0, *, seed=0, device=None):
    """Fig 3: the deviation bites through (a) the DQN's reward (the DT
    mis-estimates compute energy -> noisy TD targets) and (b) the trust
    weights (deviation-normalized belief, Eqn 4) with malicious clients."""
    accs = {}
    data, parts = fed_setup(n_devices=8, n=2048, dim=96, seed=1 + seed,
                            device=device)
    for label, calibrate in [("calibrated", True), ("with_deviation", False)]:
        out = train_dqn_agent(episodes=4, horizon=25, calibrate=calibrate,
                              seed=1 + seed, device=device)
        cfg = core.AsyncFLConfig(n_devices=8, n_clusters=2, local_batch=48,
                                 sim_seconds=sim_seconds,
                                 calibrate_dt=calibrate, dt_max_dev=0.3,
                                 malicious_frac=0.25, seed=1 + seed)
        tr = core.AsyncFederation(cfg, data, parts, agent=out["agent"],
                                  dqn_cfg=out["dcfg"],
                                  device=device).run(eval_every=2.0)
        accs[label] = tr.accs[-1]
        print(f"fig3,acc_{label},{tr.accs[-1]:.4f}")
    return accs


def _greedy_rollout(agent, dcfg, p, seed, loss_target=0.35, max_steps=200):
    """The greedy policy until the loss target: (aggregations, mean chosen
    a_i, energy consumed).  No budget truncation, so the CHANNEL-driven
    differences show (the paper's Fig 4/5 protocol).  The loop reads the
    loss back to the host once a step, as the JAX package's does; the
    draws are keyed by (``seed``, the env's round) on their own stream."""
    p = p._replace(budget=1e9, horizon=max_steps)
    dev = agent.step.device
    rs = int(rng.hash32(seed, 0, rng.ROLLOUT, 0, 0))
    s, obs = envs.reset(p, envs.draw_reset(rs, 0, p, dev))
    idx = torch.arange(2 + 2 * p.n_devices, device=dev)
    steps = 0
    e_tot = torch.zeros((), dtype=torch.float64, device=dev)
    a_sum = torch.zeros((), dtype=torch.int64, device=dev)
    while float(s.loss) > loss_target and steps < max_steps:
        a = torch.argmax(core.q_values(agent.eval_params, obs))
        draws = envs.draw_step(rng.uniform(rs, 0, rng.DQN_STEP, s.round,
                                           idx), s.channel)
        s, obs, _, _, info = envs.step(s, a, p, draws)
        steps += 1
        a_sum += a + 1
        e_tot += info["consumed"].double()
    return steps, float(a_sum) / max(steps, 1), float(e_tot)


def fig4_channel_adaptation(episodes=6, *, seed=0, device=None):
    """Aggregations to target + chosen frequency against the channel
    distribution: in bad channels the agent picks more local steps per
    aggregation (larger a_i), so the aggregation count falls as p_good ->
    0 relative to its local-step budget (the paper's Fig 4 mechanism)."""
    rows = {}
    for p_good in [0.0, 0.2, 0.5, 0.8, 1.0]:
        out = train_dqn_agent(episodes=episodes, p_good=p_good, horizon=30,
                              seed=2 + seed, device=device)
        p = envs.EnvParams(p_good=p_good)
        aggs, mean_a, _ = _greedy_rollout(out["agent"], out["dcfg"], p,
                                          42 + seed)
        rows[p_good] = (aggs, mean_a)
        print(f"fig4,aggs_to_target_pgood_{p_good},{aggs}")
        print(f"fig4,mean_a_pgood_{p_good},{mean_a:.2f}")
    return rows


def fig5_energy_by_channel(episodes=6, *, seed=0, device=None):
    """Energy to reach the loss target: the early-training agent against
    the trained one, per channel state (the paper's Fig 5: energy falls
    over DQN training and with channel quality)."""
    rows = {}
    for label, p_good in [("good", 0.9), ("medium", 0.5), ("bad", 0.1)]:
        early = train_dqn_agent(episodes=1, p_good=p_good, horizon=30,
                                seed=3 + seed, device=device)
        late = train_dqn_agent(episodes=episodes, p_good=p_good, horizon=30,
                               seed=3 + seed, device=device)
        p = envs.EnvParams(p_good=p_good)
        _, _, e_early = _greedy_rollout(early["agent"], early["dcfg"], p,
                                        7 + seed)
        _, _, e_late = _greedy_rollout(late["agent"], late["dcfg"], p,
                                       7 + seed)
        rows[label] = (e_early, e_late)
        print(f"fig5,energy_{label}_early,{e_early:.3f}")
        print(f"fig5,energy_{label}_trained,{e_late:.3f}")
    return rows


def fig6_fig7_clustering(sim_seconds=12.0, target_acc=0.8, *, seed=0,
                         device=None):
    data, parts = fed_setup(n_devices=16, n=3072, dim=96, seed=4 + seed,
                            device=device)
    curves, tta = {}, {}
    for k in [1, 2, 4, 8]:
        cfg = core.AsyncFLConfig(n_devices=16, n_clusters=k, local_batch=48,
                                 sim_seconds=sim_seconds, seed=4 + seed)
        tr = core.AsyncFederation(cfg, data, parts,
                                  device=device).run(eval_every=1.5)
        curves[k] = (tr.times, tr.accs)
        reach = [t for t, a in zip(tr.times, tr.accs) if a >= target_acc]
        tta[k] = reach[0] if reach else float("inf")
        print(f"fig6,final_acc_k{k},{tr.accs[-1]:.4f}")
        print(f"fig7,time_to_{target_acc}_k{k},{tta[k]:.2f}")
    return dict(curves={k: v[1] for k, v in curves.items()}, tta=tta)


def fig8_adaptive_vs_fixed(sim_seconds=4.0, *, seed=0, device=None):
    """Accuracy within a short simulated budget (before saturation):
    mid-training accuracy is where frequency adaptation shows (the
    paper's Fig 8)."""
    data, parts = fed_setup(n_devices=8, n=3072, dim=784, seed=5 + seed,
                            device=device)
    out = train_dqn_agent(episodes=4, horizon=25, seed=5 + seed,
                          device=device)
    base = core.AsyncFLConfig(n_devices=8, n_clusters=2, local_batch=48,
                              sim_seconds=sim_seconds, seed=5 + seed)
    tr_a = core.AsyncFederation(base, data, parts, agent=out["agent"],
                                dqn_cfg=out["dcfg"],
                                device=device).run(eval_every=1.0)
    accs = {"adaptive": tr_a.accs[-1]}
    print(f"fig8,acc_adaptive,{tr_a.accs[-1]:.4f}")
    for f in [1, 5, 10]:
        cfg = dataclasses.replace(base, fixed_frequency=f)
        tr_f = core.AsyncFederation(cfg, data, parts,
                                    device=device).run(eval_every=1.0)
        accs[f"fixed_{f}"] = tr_f.accs[-1]
        print(f"fig8,acc_fixed_{f},{tr_f.accs[-1]:.4f}")
    return accs


ALL = [fig2_dqn_convergence, fig3_dt_deviation, fig4_channel_adaptation,
       fig5_energy_by_channel, fig6_fig7_clustering, fig8_adaptive_vs_fixed]

__all__ = ["ALL", "fig2_dqn_convergence", "fig3_dt_deviation",
           "fig4_channel_adaptation", "fig5_energy_by_channel",
           "fig6_fig7_clustering", "fig8_adaptive_vs_fixed"]
