"""The JAX package's final accuracy and AUC at the port's card specs.

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/jax_reference.py \
        [--specs paper-adaptive-fleet1k anomaly-fleet1k dp-fleet1k
                 faulty-fleet1k faulty-median-fleet1k] [--seeds 0 1 2]

For each spec of `repro_torch.api.scenarios` named and each seed, builds
the JAX package's federation from the same spec dict (its DQN pretrained
on its DT environment, its own data from the seed), runs
``run_scanned(30)`` as `chip_smoke.py` drives the port, and prints the
final ``acc`` (the MLP's accuracy, the autoencoder's detection AUC) as one
JSON line.  These are the reference figures `chip_smoke.py` holds the port
to, less a margin; they are quality figures of the JAX package on the
CPU, not speeds.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--specs", nargs="+", default=list(SPECS),
                    choices=list(SPECS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    args = ap.parse_args()
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
