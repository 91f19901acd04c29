"""Dry run of every plan: each (architecture x input shape x mesh) traced
on a fake production mesh, with per-rank estimates of its memory, work and
traffic (the JAX package's ``launch/dryrun.py``).

The JAX module lowers and compiles each plan against 256 or 512 forced
host devices and reads XLA's memory and cost analyses.  Here each plan's
``step_fn`` runs on rank 0's shards of its meta arguments
(`repro_torch.launch.plans`) over a fake process group of 256 or 512 ranks
(`repro_torch.launch.mesh.make_production_mesh(fake=True)`): nothing is
allocated, no kernel is built, no collective moves a byte.  An
`repro_torch.launch.op_stats.OpStats` counts what the step does on that
rank.  Every rank of these meshes runs the same ops on shards of the same
shapes, so rank 0 stands for each.

Each record keeps the JAX record's keys where the quantity is the same:
``arch``, ``shape``, ``mesh``, ``status``, ``kind``, ``chips``,
``bytes_per_device`` (``argument``: the rank's shards of the arguments;
``total``: the live storages' peak, the arguments included),
``collectives`` (bytes by kind, ``total`` and ``count``), ``op_hist``,
and the roofline terms ``t_compute`` / ``t_memory`` / ``t_collective`` in
seconds at the H100's published rates (`repro_torch.launch.mesh`; each
collective at the rate of the links its group spans).  The counted
quantities are ``flops_per_dev`` (matrix products and the hand-written
kernels' operations) and ``bytes_per_dev`` (the traffic proxy), and a
record adds ``peak_bytes_per_device`` (the peak by category), ``device``
(the card the rates are for) and ``trace_s``.  A plan `applicable` skips
is recorded with its reason, as the JAX package records it; a failure is
recorded and the sweep goes on.

Usage (CPU, no card):
    python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from typing import Any, Dict, Tuple

import torch

from ..core import fl_step as fl
from ..core import sharding as shd
from .mesh import (CARD, hbm_bytes_per_s, link_bytes_per_s,
                   make_production_mesh, n_chips, peak_flops_bf16)
from .op_stats import OpStats, op_histogram, roofline
from .plans import SHAPES, Plan, applicable, make_plan

# the arguments of each kind of plan that are placed on the mesh (the
# rest, the trust and staleness weights and a decode step's position, are
# whole on every rank) and the category of each in the memory estimate
PLACED = {"train": (0, 1), "prefill": (0, 1), "decode": (0, 1, 2)}
ARG_CATEGORIES = {"train": ("state", "inputs", "inputs", "inputs"),
                  "prefill": ("parameters", "inputs"),
                  "decode": ("parameters", "cache", "inputs", "inputs")}


def _put(t: torch.Tensor, spec, mesh):
    """This rank's DTensor of the whole tensor ``t`` at ``spec``: on the
    meta device a fresh meta shard (a view would keep the whole tensor's
    storage), elsewhere `sharding.distribute`."""
    if t.device.type != "meta":
        return shd.distribute(t, spec, mesh)
    shard = shd.local_chunk(t, spec, mesh)
    return shd.from_local(torch.empty(shard.shape, dtype=t.dtype,
                                      device="meta"), spec, mesh)


def placed_args(plan: Plan, mesh) -> tuple:
    """The plan's arguments as this rank holds them: the placed ones as
    DTensors of its shards at ``in_specs``' placements."""
    put = lambda t, s: _put(t, s, mesh)
    out = []
    for i, (arg, spec) in enumerate(zip(plan.args, plan.in_specs)):
        if i not in PLACED[plan.kind]:
            out.append(arg)
        elif isinstance(arg, fl.TrainState):
            out.append(fl.TrainState(shd.map_tree(put, arg.params,
                                                  spec.params),
                                     shd.map_tree(put, arg.opt, spec.opt),
                                     arg.round))
        elif isinstance(arg, torch.Tensor):
            out.append(put(arg, spec))
        else:
            out.append(shd.map_tree(put, arg, spec))
    return tuple(out)


def argument_bytes(args) -> int:
    """Bytes of this rank's shards of ``args``."""
    total = 0
    for t in torch.utils._pytree.tree_flatten(
            [a._asdict() if isinstance(a, fl.TrainState) else a
             for a in args])[0]:
        if isinstance(t, torch.Tensor):
            t = shd.local(t)
            total += t.numel() * t.element_size()
    return total


def trace(plan: Plan, args, *, record: bool = False) -> OpStats:
    """Run ``plan.step_fn`` on ``args`` (`placed_args`) under an
    `OpStats`, the arguments registered by category."""
    from ..models.transformer import structure
    stats = OpStats(record=record)
    stats.name_modules(structure(plan.cfg))     # the model the step runs
    for arg, cat in zip(args, ARG_CATEGORIES[plan.kind]):
        if isinstance(arg, fl.TrainState):
            stats.track("parameters", arg.params)
            stats.track("optimizer", arg.opt)
        else:
            stats.track(cat, arg)
    with stats:
        plan.step_fn(*args)
    return stats


def estimate(plan: Plan, mesh, *, record: bool = False
             ) -> Tuple[OpStats, int]:
    """-> (the `OpStats` of the plan's step on this rank, its arguments'
    bytes), the arguments placed from ``plan.args`` (meta or real)."""
    args = placed_args(plan, mesh)
    n_arg = argument_bytes(args)
    return trace(plan, args, record=record), n_arg


def record_of(stats: OpStats, n_arg: int, chips: int) -> Dict[str, Any]:
    """The record's counted fields of one traced step."""
    coll = {k: v["bytes"] for k, v in stats.collectives.items()}
    coll["total"] = stats.collective_bytes
    coll["count"] = sum(v["calls"] for v in stats.collectives.values())
    rec = {"chips": chips,
           "bytes_per_device": {"argument": n_arg,
                                "total": stats.peak_bytes},
           "peak_bytes_per_device": stats.summary()["peak"],
           "flops_per_dev": stats.flops,
           "bytes_per_dev": stats.traffic_bytes,
           "kernel_flops_per_dev": dict(stats.kernel_flops),
           "collectives": coll,
           "op_hist": op_histogram(stats),
           "device": CARD}
    rec.update(roofline(stats, peak_flops_bf16(), hbm_bytes_per_s(),
                        link_bytes_per_s))
    return rec


def run_one(arch: str, shape: str, multi_pod: bool,
            verbose: bool = True) -> Dict[str, Any]:
    rec: Dict[str, Any] = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if multi_pod else "16x16"}
    skip = applicable(arch, shape)
    if skip:
        rec["status"] = skip
        return rec
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
        plan = make_plan(arch, shape, mesh)
        stats, n_arg = estimate(plan, mesh)
        rec.update({"status": "ok", "kind": plan.kind})
        rec.update(record_of(stats, n_arg, n_chips(mesh)))
        rec["trace_s"] = round(time.time() - t0, 1)
        if verbose:
            b = rec["bytes_per_device"]
            print(f"[{rec['mesh']}] {arch} x {shape}: OK "
                  f"(trace {rec['trace_s']}s)")
            print(f"  per rank: arguments {b['argument'] / 2**30:.2f} GiB, "
                  f"peak {b['total'] / 2**30:.2f} GiB "
                  f"{rec['peak_bytes_per_device']}")
            print(f"  flops={rec['flops_per_dev']:.3e} "
                  f"bytes={rec['bytes_per_dev']:.3e}")
            print(f"  collectives: {rec['collectives']}")
    except Exception as e:  # noqa: BLE001 -- record and continue the sweep
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{rec['mesh']}] {arch} x {shape}: FAILED -- {e}")
    return rec


def main(argv=None) -> int:
    from ..configs import ARCH_IDS
    ap = argparse.ArgumentParser(
        description="per-rank estimates of every plan on a fake mesh")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None,
                    help="append each record to this JSONL file")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    records = []
    t0 = time.time()
    for a in archs:
        for s in shapes:
            rec = run_one(a, s, args.multi_pod)
            records.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    ok = sum(r["status"] == "ok" for r in records)
    skipped = sum(r["status"].startswith("skip") for r in records)
    print(f"\n{ok} ok / {skipped} skipped / "
          f"{len(records) - ok - skipped} failed of {len(records)} "
          f"in {time.time() - t0:.1f} s")
    return 0 if ok + skipped == len(records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
