"""Profile of one plan: the JAX package's ``launch/profile.py`` for the
port, from the per-rank estimates of `repro_torch.launch.dryrun`.

It prints the plan's roofline terms (seconds at the H100's published
rates, `repro_torch.launch.mesh`), its traffic by op kind, its hottest
layers by traffic (the counterpart of the JAX profile's hottest loops) and
its per-rank peak by category (`repro_torch.launch.op_stats`).  By default
the plan is traced on the fake production mesh, nothing allocated, on the
CPU.  With ``--device cuda`` and a cut depth (``--layers``) it builds the
plan on one card (mesh (1, 1)), estimates it the same way on meta
arguments, then runs the step for real on arguments drawn from a seed: a
warm-up call, a timed call (its wall seconds and
``torch.cuda.max_memory_allocated()``), and a call under the same counter,
whose operations must equal the estimate's.  The JAX profile had no wall
clock.  ``--batch`` shortens a training plan's global batch for such a
run, so that a step fits on one card; a serving plan keeps its shape's.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch \\
        falcon-mamba-7b --shape train_4k [--multi-pod] [--save f.json]
    python -m repro_torch.launch.profile --arch recurrentgemma-2b \\
        --shape train_4k --device cuda --layers 3 --batch 4   # on a card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional

import torch

from .dryrun import estimate, record_of
from .mesh import (CARD, hbm_bytes_per_s, make_host_mesh,
                   make_production_mesh, n_chips)
from .op_stats import OpStats, hottest_layers, traffic_breakdown
from .plans import SHAPES, make_plan, materialize


def cut_config(arch: str, layers: Optional[int]):
    """The architecture's config, cut to ``layers`` layers (whole periods
    of its block pattern kept whole by the caller's choice)."""
    from ..configs import get_config
    cfg = get_config(arch)
    return cfg if not layers else dataclasses.replace(cfg, num_layers=layers)


def report(title: str, stats: OpStats, rec: Dict[str, Any]) -> None:
    print(f"== {title} ==")
    print(f"t_compute    {rec['t_compute']:10.4f}s   "
          f"({stats.flops:.3e} flop/rank, of which kernels "
          f"{sum(stats.kernel_flops.values()):.3e})")
    print(f"t_memory     {rec['t_memory']:10.4f}s   "
          f"({stats.traffic_bytes:.3e} B/rank)")
    print(f"t_collective {rec['t_collective']:10.4f}s   "
          f"({stats.collective_bytes:.3e} B/rank)")
    b = rec["bytes_per_device"]
    print(f"mem/rank: arguments {b['argument'] / 1e9:.2f} GB, peak "
          f"{b['total'] / 1e9:.2f} GB: " + ", ".join(
              f"{k} {v / 1e9:.2f}" for k, v in
              rec["peak_bytes_per_device"].items()))
    print("collectives:", {k: f"{v['bytes']:.2e} B in {v['calls']}"
                           for k, v in stats.collectives.items()})
    print("\ntraffic by op kind:")
    for k, v in list(traffic_breakdown(stats).items())[:15]:
        print(f"  {k:<28} {v:.3e} B  ({v / hbm_bytes_per_s():8.4f}s)")
    print("\nhottest layers (traffic):")
    for k, v in hottest_layers(stats).items():
        print(f"  {k:<12} {v:.3e} B")
    print(f"(rates: {CARD})", flush=True)


def profile(arch: str, shape: str, multi_pod: bool = False,
            save: Optional[str] = None, device: Optional[str] = None,
            layers: Optional[int] = None, batch: Optional[int] = None
            ) -> Dict[str, Any]:
    """Estimate (and with ``device`` 'cuda' run) one plan; -> the record."""
    if device is None:
        mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
        plan = make_plan(arch, shape, mesh, cfg=cut_config(arch, layers))
        stats, n_arg = estimate(plan, mesh)
        rec = record_of(stats, n_arg, n_chips(mesh))
        report(f"{arch} x {shape} ({'2x16x16' if multi_pod else '16x16'}, "
               f"rank 0)", stats, rec)
    else:
        rec = run_on_card(arch, shape, torch.device(device), layers, batch)
    if save:
        with open(save, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


def run_on_card(arch, shape, dev, layers, batch=None,
                seed: int = 0) -> Dict[str, Any]:
    """The plan at mesh (1, 1) on ``dev``: its estimate on meta arguments,
    then the step run for real (module notes)."""
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"--device {dev} runs the step on a card, and "
                           "this process has none")
    from .dryrun import placed_args, trace
    mesh = make_host_mesh(1, 1, device="cuda")
    cfg = cut_config(arch, layers)
    kw = dict(global_batch=batch) if SHAPES[shape]["kind"] == "train" \
        else {}
    plan = make_plan(arch, shape, mesh, cfg=cfg, **kw)
    stats, n_arg = estimate(plan, mesh)
    rec = record_of(stats, n_arg, 1)
    report(f"{arch} x {shape}, {cfg.num_layers} layers, mesh (1, 1): "
           "estimate", stats, rec)
    real = materialize(plan, dev, seed)
    torch.cuda.synchronize()
    plan.step_fn(*placed_args(real, mesh))            # warm-up, builds
    real = materialize(plan, dev, seed)
    args = placed_args(real, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plan.step_fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del args
    real = materialize(plan, dev, seed)
    counted = trace(real, placed_args(real, mesh))
    rec.update({"arch": arch, "shape": shape, "layers": cfg.num_layers,
                "wall_s": wall, "max_memory_allocated": peak,
                "measured_flops": counted.flops,
                "peak_ratio": peak / stats.peak_bytes,
                "device": torch.cuda.get_device_name(0)})
    print(f"\nmeasured on {rec['device']}: wall {wall:.3f} s, "
          f"max_memory_allocated {peak / 1e9:.3f} GB (estimate "
          f"{stats.peak_bytes / 1e9:.3f} GB, ratio {rec['peak_ratio']:.3f})"
          f", operations {counted.flops:.4e} (estimate {stats.flops:.4e})",
          flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one plan's per-rank profile")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--save", default=None,
                    help="write the record to this JSON file")
    ap.add_argument("--device", default=None, choices=["cuda"],
                    help="also run the step on this card at mesh (1, 1)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--batch", type=int, default=None,
                    help="a training plan's global batch")
    args = ap.parse_args(argv)
    profile(args.arch, args.shape, args.multi_pod, args.save, args.device,
            args.layers, args.batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

