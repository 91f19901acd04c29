"""The paper's evaluation in one command: every figure, then the
robustness grid, as ``name,metric,value`` rows.

    python -m repro_torch.paper [--quick] [--device cpu] [--out grid.json]

``--quick`` runs Fig 2 (2 episodes) and Fig 3 (4 simulated seconds)
only, as the JAX package's ``benchmarks/run.py --quick`` does.  Each
figure's seconds follow its rows as ``<fig>,seconds,<s>``.  The TPU
kernel benchmarks of ``benchmarks/run.py`` have no counterpart here.
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device

from . import figures, robustness
from .common import timed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="Figs 2 and 3 at a reduced length, no grid")
    ap.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")
    ap.add_argument("--out", default=None,
                    help="write the robustness grid's JSON to this path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("benchmark,metric,value")
    if args.quick:
        runs = [(figures.fig2_dqn_convergence, dict(episodes=2)),
                (figures.fig3_dt_deviation, dict(sim_seconds=4.0))]
    else:
        runs = [(fn, {}) for fn in figures.ALL]
    for fn, kw in runs:
        us, _ = timed(lambda: fn(**kw, device=dev), warmup=0, iters=1,
                      device=dev)
        print(f"{fn.__name__.split('_')[0]},seconds,{us / 1e6:.3f}")
    if not args.quick:
        robustness.run(out_path=args.out, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
