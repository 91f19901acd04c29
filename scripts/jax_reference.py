"""The JAX package's final accuracy and AUC at the port's card specs, and
its figures of the paper and robustness grid over seeds.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/jax_reference.py \
        [--specs paper-adaptive-fleet1k anomaly-fleet1k dp-fleet1k
                 faulty-fleet1k faulty-median-fleet1k] [--seeds 0 1 2]
    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/jax_reference.py \
        --figures [--seeds 0 1 2 3 4] [--no-grid]

For each spec of `repro_torch.api.scenarios` named and each seed, builds
the JAX package's federation from the same spec dict (its DQN pretrained
on its DT environment, its own data from the seed), runs
``run_scanned(30)`` as `chip_smoke.py` drives the port, and prints the
final ``acc`` (the MLP's accuracy, the autoencoder's detection AUC) as one
JSON line.

``--figures`` runs the protocol of the JAX package's
``benchmarks/figures.py`` (Figs 2-8) through its own building blocks,
unchanged (``benchmarks.common.train_dqn_agent(seed=)``, ``fed_setup(seed=)``,
``benchmarks.figures._greedy_rollout``, ``repro.core.AsyncFederation``
with ``AsyncFLConfig(seed=)``), with every seed of the protocol offset by
each of ``--seeds`` (0-4 by default), as `repro_torch.paper.figures` takes
its ``seed``.  It prints one JSON line per metric: its value at each
offset, their least, greatest and mean.  Then it runs
``benchmarks/attack_bench.py`` once (its seeds are fixed) into a temporary
file and prints each grid cell and each recovery as a JSON line.

These are the reference figures `chip_smoke.py` holds the port to, less a
margin; they are quality figures of the JAX package on the CPU, not
speeds.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SPECS = {"paper-adaptive-fleet1k": "PAPER_ADAPTIVE_FLEET1K",
         "anomaly-fleet1k": "ANOMALY_FLEET1K",
         "dp-fleet1k": "DP_FLEET1K",
         "faulty-fleet1k": "FAULTY_FLEET1K",
         "faulty-median-fleet1k": "FAULTY_MEDIAN_FLEET1K"}
ROUNDS = 30


def jax_figures(off: int) -> dict:
    """The JAX package's Figs 2-8 with every protocol seed offset by
    ``off``: ``{"<fig>,<metric>": value}``, the rows
    ``benchmarks/figures.py`` prints."""
    import dataclasses

    import jax
    import numpy as np

    import repro.core as core
    from benchmarks.common import fed_setup, train_dqn_agent
    from benchmarks.figures import _greedy_rollout
    from repro.core import envs
    m = {}
    # Fig 2
    l = np.asarray(train_dqn_agent(episodes=8, seed=off)["td_losses"])
    k = max(1, len(l) // 20)
    smooth = np.convolve(l, np.ones(k) / k, mode="valid")
    early, late = float(smooth[:k].mean()), float(smooth[-k:].mean())
    m.update({"fig2,td_loss_early": early, "fig2,td_loss_late": late,
              "fig2,converged": int(late < early)})
    # Fig 3
    data, parts = fed_setup(n_devices=8, n=2048, dim=96, seed=1 + off)
    for label, calibrate in [("calibrated", True), ("with_deviation", False)]:
        out = train_dqn_agent(episodes=4, horizon=25, calibrate=calibrate,
                              seed=1 + off)
        cfg = core.AsyncFLConfig(n_devices=8, n_clusters=2, local_batch=48,
                                 sim_seconds=10.0, calibrate_dt=calibrate,
                                 dt_max_dev=0.3, malicious_frac=0.25,
                                 seed=1 + off)
        tr = core.AsyncFederation(cfg, data, parts, agent=out["agent"],
                                  dqn_cfg=out["dcfg"]).run(eval_every=2.0)
        m[f"fig3,acc_{label}"] = tr.accs[-1]
    # Fig 4
    for p_good in [0.0, 0.2, 0.5, 0.8, 1.0]:
        out = train_dqn_agent(episodes=6, p_good=p_good, horizon=30,
                              seed=2 + off)
        aggs, mean_a, _ = _greedy_rollout(
            out["agent"], out["dcfg"], envs.EnvParams(p_good=p_good),
            jax.random.PRNGKey(42 + off))
        m[f"fig4,aggs_to_target_pgood_{p_good}"] = aggs
        m[f"fig4,mean_a_pgood_{p_good}"] = mean_a
    # Fig 5
    for label, p_good in [("good", 0.9), ("medium", 0.5), ("bad", 0.1)]:
        p = envs.EnvParams(p_good=p_good)
        for stage, episodes in (("early", 1), ("trained", 6)):
            out = train_dqn_agent(episodes=episodes, p_good=p_good,
                                  horizon=30, seed=3 + off)
            m[f"fig5,energy_{label}_{stage}"] = _greedy_rollout(
                out["agent"], out["dcfg"], p,
                jax.random.PRNGKey(7 + off))[2]
    # Figs 6 and 7
    data, parts = fed_setup(n_devices=16, n=3072, dim=96, seed=4 + off)
    for k in [1, 2, 4, 8]:
        cfg = core.AsyncFLConfig(n_devices=16, n_clusters=k, local_batch=48,
                                 sim_seconds=12.0, seed=4 + off)
        tr = core.AsyncFederation(cfg, data, parts).run(eval_every=1.5)
        reach = [t for t, a in zip(tr.times, tr.accs) if a >= 0.8]
        m[f"fig6,final_acc_k{k}"] = tr.accs[-1]
        m[f"fig7,time_to_0.8_k{k}"] = reach[0] if reach else float("inf")
    # Fig 8
    data, parts = fed_setup(n_devices=8, n=3072, dim=784, seed=5 + off)
    out = train_dqn_agent(episodes=4, horizon=25, seed=5 + off)
    base = core.AsyncFLConfig(n_devices=8, n_clusters=2, local_batch=48,
                              sim_seconds=4.0, seed=5 + off)
    m["fig8,acc_adaptive"] = core.AsyncFederation(
        base, data, parts, agent=out["agent"],
        dqn_cfg=out["dcfg"]).run(eval_every=1.0).accs[-1]
    for f in [1, 5, 10]:
        m[f"fig8,acc_fixed_{f}"] = core.AsyncFederation(
            dataclasses.replace(base, fixed_frequency=f), data,
            parts).run(eval_every=1.0).accs[-1]
    return m


def figures_main(seeds, grid: bool) -> None:
    import contextlib
    import tempfile
    sys.path.insert(0, ROOT)            # the JAX package's benchmarks/
    per_seed = {}
    for off in seeds:
        t0 = time.perf_counter()
        per_seed[off] = jax_figures(off)
        print(json.dumps({"figures_seed": off,
                          "seconds": time.perf_counter() - t0}),
              file=sys.stderr, flush=True)
    for name in per_seed[seeds[0]]:
        vals = [float(per_seed[off][name]) for off in seeds]
        print(json.dumps({"metric": name, "seeds": list(seeds),
                          "values": vals, "min": min(vals),
                          "max": max(vals),
                          "mean": sum(vals) / len(vals)}), flush=True)
    if not grid:
        return
    from benchmarks import attack_bench
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(sys.stderr):
            out = attack_bench.run(out_path=os.path.join(tmp, "grid.json"))
    for row in out["grid"]:
        print(json.dumps({"grid": row}), flush=True)
    for row in out["recovery"]:
        print(json.dumps({"recovery": row}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--specs", nargs="+", default=list(SPECS),
                    choices=list(SPECS))
    ap.add_argument("--seeds", nargs="+", type=int, default=None,
                    help="0 1 2 for the specs, 0-4 for --figures")
    ap.add_argument("--figures", action="store_true",
                    help="the paper's figures and the robustness grid")
    ap.add_argument("--no-grid", action="store_true",
                    help="with --figures: skip the robustness grid")
    args = ap.parse_args()
    if args.figures:
        figures_main(args.seeds or [0, 1, 2, 3, 4], not args.no_grid)
        return
    args.seeds = args.seeds or [0, 1, 2]
    import jax
    from repro.api import Federation
    from repro_torch.api import scenarios
    for name in args.specs:
        for seed in args.seeds:
            d = {**getattr(scenarios, SPECS[name]), "seed": seed}
            t0 = time.perf_counter()
            fed = Federation.from_dict(d)
            rec = fed.engine.run_scanned(ROUNDS).records
            print(json.dumps({
                "spec": name, "seed": seed, "rounds": ROUNDS,
                "final_acc": rec[-1].acc, "final_loss": rec[-1].loss,
                "actions": sorted({r.a for r in rec[:-1]}),
                "seconds": time.perf_counter() - t0,
                "platform": jax.devices()[0].platform,
                "host_peak_rss_mib": resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 1024}), flush=True)


if __name__ == "__main__":
    main()
