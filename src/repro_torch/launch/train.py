"""Federated training driver.

Runs the full control plane at example scale on one device: digital twins,
(optionally DQN-driven) aggregation frequency, trust-weighted mode-A train
steps of a reduced architecture, the Eqn-12 energy queue.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --steps 50 --clients 4 --device cpu

The flags are those of the JAX package's ``repro.launch.train``, whose
``--smoke`` is always on (``store_true`` with ``default=True``), so the CLI
trains the smoke config; `repro_torch.core.fl_step` takes any config, the
full-width one included.  ``--device`` defaults to the card.  Parameters,
twins, the agent and the token batches are drawn from seed 0 by the
port's generators (the JAX package's keys cannot be reproduced), and each
draw is made before it is used, as everywhere in the port.  ``--ckpt``
saves the parameters in the JAX package's tree layout.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch
import torch.nn.functional as F

from ..checkpoint import save_checkpoint
from ..configs import get_config, get_smoke_config
from ..core import fl_step
from ..core.dqn import DQNConfig, init_dqn, select_action
from ..core.energy import GOOD, comm_energy, compute_energy, draw_noise
from ..core.envs import OBS_DIM
from ..core.lyapunov import init_queue, step_queue
from ..core.trust import belief, learning_quality, update_reputation
from ..core.twin import (calibrate, calibrated_freq, draw_twins,
                         sample_deviation)
from ..data.synthetic import token_stream
from ..device import resolve_device
from ..models.transformer import tree_from_named
from ..optim import adam


def make_fed_lm_batch(generator: torch.Generator, cfg, n_clusters: int,
                      clients: int, n_micro: int, bm: int, seq: int,
                      device=None):
    """Zipf token batches (NC, C, n_micro, Bm, S) for mode A."""
    shape = (n_clusters, clients, n_micro, bm, seq + 1)
    if cfg.num_codebooks > 1:
        shape = shape[:-1] + (cfg.num_codebooks, seq + 1)
    toks = token_stream(generator, math.prod(shape), cfg.vocab_size
                        ).reshape(shape).to(device)
    return {"tokens": toks[..., :-1].contiguous(),
            "labels": toks[..., 1:].contiguous()}


def _to(twins, device):
    return dataclasses.replace(twins, **{
        f.name: getattr(twins, f.name).to(device)
        for f in dataclasses.fields(twins)})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=0,
                    help="0 = DQN-driven adaptive frequency")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    g = torch.Generator().manual_seed(0)
    NC, C = args.clusters, args.clients

    opt = adam(3e-4)
    init = fl_step.build_init_fn(cfg, opt, mode=fl_step.MODE_A,
                                 n_clusters=NC, clients_per_cluster=C,
                                 device=dev)
    state = init(0)

    # digital twins of the simulated fleet + trust state
    twins = draw_twins(NC * C, g)
    twins = _to(sample_deviation(twins, torch.rand((NC * C,), generator=g)
                                 * 0.2), dev)
    rep = torch.ones((NC, C), device=dev)
    queue = init_queue(budget=50.0, horizon=args.steps)

    # DQN agent for adaptive frequency (a fresh agent, as in the JAX CLI)
    agent = dcfg = None
    if args.local_steps == 0:
        dcfg = DQNConfig(buffer_size=256, batch_size=32)
        agent = init_dqn(g, dcfg, device=dev)

    steps = {a_i: fl_step.build_train_step(cfg, opt, mode=fl_step.MODE_A,
                                           local_steps=a_i)
             for a_i in range(1, 5)}

    print("step,a_i,loss,queue,seconds")
    for i in range(args.steps):
        batch = make_fed_lm_batch(g, cfg, NC, C, 1, args.batch, args.seq,
                                  device=dev)
        if agent is not None:
            obs = F.pad(torch.tensor([float(queue.q), i / args.steps, 0.0]),
                        (0, OBS_DIM - 3)).to(dev)
            u = torch.rand((), generator=g).to(dev)
            rand_a = torch.randint(0, dcfg.n_actions, (), generator=g).to(dev)
            a_i = int(select_action(agent, dcfg, obs, u, rand_a)) % 4 + 1
        else:
            a_i = args.local_steps
        stale = torch.zeros((NC,), device=dev)
        t0 = time.time()
        state, metrics = steps[a_i](state, batch, rep, stale)
        loss = float(metrics["loss"].mean())
        # energy + queue + trust updates from the DT
        e = float(compute_energy(calibrated_freq(twins)).mean()) * a_i
        good = torch.full((NC * C,), GOOD, dtype=torch.int64, device=dev)
        noise = draw_noise(torch.rand((NC * C,), generator=g).to(dev), good)
        e += float(comm_energy(good, noise).mean())
        queue = step_queue(queue, e)
        div = metrics["divergence"].reshape(-1)
        q = learning_quality(div[:, None])
        b = belief(twins, q, pkt_fail=0.05)
        rep = update_reputation(rep, b.reshape(NC, C), 0.05)
        twins = calibrate(twins)
        print(f"{i},{a_i},{loss:.4f},{float(queue.q):.3f},"
              f"{time.time() - t0:.2f}")

    if args.ckpt:
        tree = tree_from_named(state.params, cfg, lead=2)
        f = save_checkpoint(args.ckpt, args.steps, tree)
        print(f"saved,{f}")


if __name__ == "__main__":
    main()
