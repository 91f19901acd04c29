"""Shared helpers of the paper's figures: a timer, Alg.-1 DQN training on
the DT environment, and the federated data set-up.

The counterparts of the JAX package's ``benchmarks/common.py``, built on
the port: `train_dqn_agent` runs `repro_torch.control.train_on_env` (the
whole training on the device, its draws split from their use) and reads
its per-step record back once at the end.
"""
from __future__ import annotations

import time

import torch

from repro_torch import rng
from repro_torch.control.scanned_dqn import train_on_env
from repro_torch.core import dqn as dqn_lib
from repro_torch.core import envs
from repro_torch.data import dirichlet_partition, make_classification
from repro_torch.device import resolve_device

__all__ = ["timed", "train_dqn_agent", "fed_setup", "sync"]


def sync(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, *args, warmup=1, iters=3, device=None):
    """Microseconds a call of ``fn(*args)`` takes, and its last output.
    On the card each call lies between two CUDA events recorded on the
    current stream and read after a synchronize, so work still queued when
    ``fn`` returns is counted; on the CPU, the host's clock."""
    dev = torch.device("cuda" if device is None else device)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / iters * 1e3, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6, out


def train_dqn_agent(episodes=8, horizon=40, p_good=0.5, calibrate=True,
                    seed=0, device=None):
    """Algorithm 1 on the DT-simulated environment, on ``device`` (the
    card unless the caller asks for another).  Returns the JAX package's
    dict: the agent and its config, each step's TD loss (``td_losses``),
    and each episode's return, consumed energy and aggregation count."""
    dev = resolve_device(device)
    p = envs.EnvParams(horizon=horizon, p_good=p_good, calibrate_dt=calibrate)
    dcfg = dqn_lib.DQNConfig(buffer_size=1024, batch_size=32, lr=2e-3)
    agent = dqn_lib.init_dqn(rng.generator(seed, rng.DQN_INIT), dcfg, dev)
    agent, aux = train_on_env(agent, dcfg, p, episodes=episodes, seed=seed)
    lens = aux["ep_len"].tolist()               # the one read to the host
    td = aux["td_loss"].cpu()
    used = aux["consumed"].cpu().double()
    return dict(agent=agent, dcfg=dcfg,
                td_losses=[v for e, n in enumerate(lens)
                           for v in td[e, :n].tolist()],
                rewards=aux["ep_return"].tolist(),
                energies=[float(used[e, :n].sum())
                          for e, n in enumerate(lens)],
                agg_counts=lens, params=p)


def fed_setup(n_devices=16, n=4096, dim=784, seed=0, device=None):
    """The MNIST-shaped synthetic task from ``seed`` (drawn on the CPU, so
    a seed gives the same data everywhere), moved to ``device``, and its
    Dirichlet non-IID partition over ``n_devices``."""
    dev = resolve_device(device)
    data = make_classification(rng.generator(seed, rng.DATA), n=n, dim=dim)
    parts = dirichlet_partition(data.y.numpy(), n_devices, seed=seed)
    return data._replace(x=data.x.to(dev), y=data.y.to(dev),
                         prototypes=data.prototypes.to(dev)), parts
