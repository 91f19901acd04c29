"""Robustness grid: (fault mode x aggregator) on both workloads, on the port.

The port's counterpart of the JAX package's ``benchmarks/attack_bench.py``
(the same `FAULTS` table, specs and JSON layout).  The paper claims that
trust-weighted aggregation (Eqns 4-6) "effectively resists malicious
attacks"; the grid injects declarative faults (`FederationSpec.faults`)
inside the round and measures the final metric with and without trust:

* ``mlp``                  non-IID classification; metric = accuracy
* ``autoencoder-anomaly``  reconstruction anomaly detection; metric = AUC
  (labels never enter the loss, so ``poison``, which corrupts the inputs,
  is its only data attack)

A cell whose training diverges to NaN (fedavg under the strongest attacks;
that is the result) scores 0.0 with ``diverged: true``.

The trust and fedavg cells of one fault mode differ only in a lifted
per-member flag, so they run as one B = 2 `repro_torch.pop.PopulationEngine`
program; the sequential runs of the same specs are kept beside it as the
timing baseline and the check: every record's schedule exactly, its loss,
metric and energy within 1e-6 relative, NaN in the same places (a port
population promises float32 rounding, not bits; these members, of one
width, come out bit for bit through `repro_torch.core.member_ops`).

    python -m repro_torch.paper.robustness [--fast] [--out F] [--device cpu]

Prints ``attack,<workload>/<fault>/<agg>,<metric>`` rows and, with
``--out``, writes the grid, the per-fault recovery and the timing to F.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

from repro_torch.kernels import launches

from .common import sync

# per-workload fault strengths: attacks are meaningful only relative to a
# workload's own gradient scale and fragility (the autoencoder diverges
# under magnitudes the classifier shrugs off), so each workload gets the
# strongest settings its training still survives *with* trust
FAULTS = {
    "mlp": {
        "clean":     {},
        "sign_flip": {"corrupt_mode": "sign_flip", "corrupt_frac": 0.25,
                      "corrupt_scale": 4.0},
        "gaussian":  {"corrupt_mode": "gaussian", "corrupt_frac": 0.25,
                      "corrupt_scale": 8.0},
        "poison":    {"poison_frac": 0.375, "poison_scale": 8.0},
    },
    "autoencoder-anomaly": {
        "clean":     {},
        "sign_flip": {"corrupt_mode": "sign_flip", "corrupt_frac": 0.25,
                      "corrupt_scale": 3.0},
        "gaussian":  {"corrupt_mode": "gaussian", "corrupt_frac": 0.25,
                      "corrupt_scale": 8.0},
        "poison":    {"poison_frac": 0.375, "poison_scale": 4.0},
    },
}
AGGREGATORS = ("trust", "fedavg")
RTOL = 1e-6          # a population member against its sequential run


def _close(a, b, rtol=RTOL) -> bool:
    """``a`` and ``b`` within ``rtol`` relative, or both NaN: a diverged
    member NaNs at the same round in both runs, and NaN != NaN would hide
    that agreement."""
    if a is None or b is None:
        return a is b
    if a != a or b != b:
        return a != a and b != b
    return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))


def same_run(got, want) -> bool:
    """Every record of ``got`` has ``want``'s schedule exactly and its
    loss, metric and energy within `RTOL`."""
    return len(got.records) == len(want.records) and all(
        (a.round, a.cluster, a.a, a.agg_count)
        == (b.round, b.cluster, b.a, b.agg_count)
        and _close(a.loss, b.loss) and _close(a.acc, b.acc)
        and _close(a.energy, b.energy)
        for a, b in zip(got.records, want.records))


def _specs(fast: bool):
    from repro_torch.api import (AggregatorSpec, ClusteringSpec,
                                 ControllerSpec, FederationSpec, FleetSpec,
                                 TaskSpec)
    mlp = FederationSpec(
        fleet=FleetSpec(n_devices=16),
        clustering=ClusteringSpec(n_clusters=2),
        controller=ControllerSpec("fixed", {"a": 5}),
        aggregator=AggregatorSpec("trust"),
        execution="scanned", rounds=12 if fast else 40, sim_seconds=1e9,
        seed=11)
    ae = FederationSpec(
        fleet=FleetSpec(n_devices=16),
        clustering=ClusteringSpec(n_clusters=2),
        controller=ControllerSpec("fixed", {"a": 3}),
        aggregator=AggregatorSpec("trust"),
        task=TaskSpec("autoencoder-anomaly",
                      {"n_samples": 2048, "dim": 32,
                       "n_types": 8, "hidden": 64, "code": 8}),
        execution="scanned", rounds=16, sim_seconds=1e9,
        local_batch=32, lr=0.1, seed=11)
    return {"mlp": mlp, "autoencoder-anomaly": ae}


def cell_specs(base, fkw):
    """The trust and fedavg specs of one fault mode."""
    from repro_torch.faults import FaultSpec
    return [dataclasses.replace(
        base, aggregator=dataclasses.replace(base.aggregator, kind=agg),
        faults=FaultSpec(**fkw)) for agg in AGGREGATORS]


def _launched(before) -> dict:
    return {k: v - before.get(k, 0) for k, v in launches.items()
            if v != before.get(k, 0)}


def run(fast: bool = False, out_path=None, device=None):
    """The whole grid on ``device`` (the card unless the caller asks for
    another); writes the JSON to ``out_path`` when one is given."""
    from repro_torch.api import Federation
    from repro_torch.device import resolve_device
    from repro_torch.pop import PopulationEngine
    dev = resolve_device(device)

    grid, timing = [], []
    for workload, base in _specs(fast).items():
        for fault, fkw in FAULTS[workload].items():
            members = cell_specs(base, fkw)
            sync(dev)
            before, t0 = dict(launches), time.perf_counter()
            traces = PopulationEngine(members,
                                      device=dev).run_scanned(base.rounds)
            sync(dev)
            t_pop, pop_launches = time.perf_counter() - t0, _launched(before)
            before, t0 = dict(launches), time.perf_counter()
            refs = [Federation.from_spec(s, device=dev).run_scanned(s.rounds)
                    for s in members]
            sync(dev)
            t_seq, seq_launches = time.perf_counter() - t0, _launched(before)
            timing.append({"workload": workload, "fault": fault,
                           "members": len(members),
                           "population_s": round(t_pop, 3),
                           "sequential_s": round(t_seq, 3),
                           "wall_clock_delta_s": round(t_seq - t_pop, 3),
                           "speedup": round(t_seq / max(t_pop, 1e-9), 2),
                           "population_launches": pop_launches,
                           "sequential_launches": seq_launches})
            for agg, tr, ref in zip(AGGREGATORS, traces, refs):
                assert same_run(tr, ref), \
                    f"population/{workload}/{fault}/{agg} diverged from " \
                    "its sequential run"
                rec = tr.records[-1]
                loss_f, acc_f = float(rec.loss), float(rec.acc)
                diverged = math.isnan(acc_f) or math.isnan(loss_f)
                row = {"workload": workload, "fault": fault,
                       "aggregator": agg, "rounds": base.rounds,
                       "final_metric": 0.0 if math.isnan(acc_f) else acc_f,
                       "final_loss": None if math.isnan(loss_f) else loss_f,
                       "diverged": diverged}
                grid.append(row)
                print(f"attack,{workload}/{fault}/{agg},"
                      f"{row['final_metric']:.4f}"
                      f"{' (diverged)' if diverged else ''}")

    by = {(r["workload"], r["fault"], r["aggregator"]): r["final_metric"]
          for r in grid}
    recovery = [
        {"workload": w, "fault": f,
         "trust": by[(w, f, "trust")], "fedavg": by[(w, f, "fedavg")],
         "trust_recovery": round(by[(w, f, "trust")]
                                 - by[(w, f, "fedavg")], 4)}
        for w in FAULTS for f in FAULTS[w] if f != "clean"]
    out = {"bench": "robustness", "fast": fast, "grid": grid,
           "recovery": recovery, "timing": timing,
           "wall_clock_delta_s": round(sum(t["wall_clock_delta_s"]
                                           for t in timing), 3)}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
    for r in recovery:
        print(f"attack,recovery/{r['workload']}/{r['fault']},"
              f"{r['trust_recovery']:+.4f}")
    for t in timing:
        print(f"attack,walltime/{t['workload']}/{t['fault']},"
              f"{t['population_s']:.2f}s vs {t['sequential_s']:.2f}s "
              f"seq ({t['speedup']}x)")
    if out_path:
        print(f"wrote {out_path}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", action="store_true",
                    help="12 mlp rounds instead of 40")
    ap.add_argument("--out", default=None,
                    help="write the grid's JSON to this path")
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    return run(fast=args.fast, out_path=args.out, device=args.device)


if __name__ == "__main__":
    main()
