"""Scenario CLI of the port.

    PYTHONPATH=src python -m repro_torch.api.run --scenario byzantine
    PYTHONPATH=src python -m repro_torch.api.run --scenario dp --sim-seconds 10
    PYTHONPATH=src python -m repro_torch.api.run --scenario faulty-fleet --rounds 5
    PYTHONPATH=src python -m repro_torch.api.run --list

A copy of the JAX package's ``repro.api.run``: each scenario is a
registered preset returning a `FederationSpec`; flags override the common
fields, and ``--spec-json`` dumps the resolved spec (the config-file
round-trip format) instead of running.  ``--device`` picks where it runs:
the card by default, ``cpu`` for the plain versions of the kernels.  A
spec the JAX package's checks reject (a datacenter spec with DP or a
robust rule) exits with code 2.  ``lm-modeA`` trains the tiny LM of the
datacenter scale (``--rounds`` sets its rounds).

``--mesh G`` (and the ``adaptive-scanned-sharded`` preset, G = 8) runs
the cluster-major engine over G ranks, one shard a rank; ``--mesh 2x2``
(any multi-axis mesh) and ``--impl gspmd`` run the partitioner-inferred
placement through DTensor over as many ranks as the mesh has shards.
Launch the CLI that many times under the ``REPRO_DIST_*`` env contract
(`repro_torch.launch.distributed.spawn_local`); rank 0 alone prints the
trace and writes ``--trace-out``.  Outside such a launch it exits with
code 2 and the placement's message, as it does for a gspmd mesh whose
ranks share a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.launch.distributed import initialize_from_env

from . import scenarios  # noqa: F401  (populates SCENARIOS)
from .federation import Federation
from .registry import SCENARIOS
from .spec import FederationSpec, ShardingSpec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.api.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="sync-baseline",
                    help=f"one of {SCENARIOS.names()}")
    ap.add_argument("--list", action="store_true",
                    help="list scenarios and exit")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--sim-seconds", type=float, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--clusters", type=int, default=None)
    ap.add_argument("--eval-every", type=float, default=3.0)
    ap.add_argument("--aggregator", default=None)
    ap.add_argument("--mesh", default=None,
                    help="mesh shape sharding the fleet, e.g. '8' or '2x2' "
                         "(needs as many ranks as shards under the "
                         "REPRO_DIST_* env)")
    ap.add_argument("--impl", default=None, choices=["shard_map", "gspmd"],
                    help="sharded execution implementation for --mesh "
                         "(default: shard_map on 1-D meshes, gspmd on "
                         "multi-axis meshes)")
    ap.add_argument("--device", default=None,
                    help="where to run: the card by default, 'cpu' for "
                         "the plain versions of the kernels")
    ap.add_argument("--spec-json", action="store_true",
                    help="print the resolved spec as JSON and exit")
    ap.add_argument("--trace-out", default="",
                    help="write the trace records to this JSON file")
    return ap


def resolve_spec(args) -> FederationSpec:
    spec = SCENARIOS.get(args.scenario)()
    if args.seed is not None:
        spec = spec.replace(seed=args.seed)
    if args.sim_seconds is not None:
        spec = spec.replace(sim_seconds=args.sim_seconds)
    if args.rounds is not None:
        spec = spec.replace(rounds=args.rounds)
    if args.devices is not None:
        spec = spec.replace(fleet=dataclasses.replace(
            spec.fleet, n_devices=args.devices))
    if args.clusters is not None:
        spec = spec.replace(clustering=dataclasses.replace(
            spec.clustering, n_clusters=args.clusters))
    if args.aggregator is not None:
        spec = spec.replace(aggregator=dataclasses.replace(
            spec.aggregator, kind=args.aggregator))
    if args.mesh is not None:
        try:
            shape = tuple(int(d) for d in
                          args.mesh.replace("x", ",").split(","))
        except ValueError:
            raise ValueError(f"--mesh {args.mesh!r}: expected a mesh shape "
                             "like '8' or '4x2'") from None
        spec = spec.replace(sharding=ShardingSpec(mesh=shape,
                                                  impl=args.impl))
    return spec.validate()


def _config_error(e: BaseException) -> int:
    print(f"error: {e.args[0] if e.args else e}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        for name in SCENARIOS.names():
            print(f"{name:16s} {SCENARIOS.get(name).__doc__.strip()}")
        return 0
    try:
        spec = resolve_spec(args)
    except (KeyError, ValueError, NotImplementedError) as e:
        return _config_error(e)
    if args.spec_json:
        print(json.dumps(spec.to_dict(), indent=2))
        return 0

    # under the REPRO_DIST_* env every rank joins the job; rank 0 alone
    # prints and writes
    lead = (initialize_from_env(device=args.device) or 0) == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"scenario={args.scenario} scale={spec.scale} "
        f"controller={spec.controller.kind} "
        f"aggregator={spec.aggregator.kind}")
    try:
        fed = Federation.from_spec(spec, device=args.device)
    except (KeyError, ValueError, RuntimeError) as e:
        # component and placement resolution failures (a mesh outside a
        # launch of as many ranks, a gspmd mesh whose ranks share a card)
        # are config errors, not tracebacks
        return _config_error(e)
    trace = fed.run(eval_every=args.eval_every)
    if not lead:
        return 0
    print("t,round,cluster,a,loss,acc,energy,aggs")
    for r in trace.records:
        acc = f"{r.acc:.3f}" if r.acc is not None else "-"
        print(f"{r.t:7.2f},{r.round},{r.cluster},{r.a},"
              f"{r.loss:.4f},{acc},{r.energy:.1f},{r.agg_count}")
    print("summary:", json.dumps(trace.summary()))
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            f.write(trace.to_json(indent=2))
        print(f"trace written to {args.trace_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
