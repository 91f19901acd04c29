"""Secure aggregation on the PyTorch/CUDA port: trust weighting against
robust baselines under a Byzantine label-flipping attack, with optional
client-level DP, through the legacy entry point
(`repro_torch.core.AsyncFederation`) at the paper's 784 input width.
Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_secure_aggregation.py [--device cpu]
"""
import argparse

import repro_torch.core as core
from repro_torch.paper import fed_setup

AGGREGATORS = ("fedavg", "trust", "median", "multi_krum")
DP_NOISE = (0.0, 0.05)


def run_cell(agg, dp, data, parts, device=None):
    """One federation of the grid: (the shim, its trace)."""
    cfg = core.AsyncFLConfig(
        n_devices=8, n_clusters=2, local_batch=64, sim_seconds=10.0,
        malicious_frac=0.25, aggregator=agg,
        dp_clip=5.0 if dp else 0.0, dp_noise=dp, seed=3)
    fed = core.AsyncFederation(cfg, data, parts, device=device)
    return fed, fed.run(eval_every=5.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    data, parts = fed_setup(n_devices=8, n=3072, dim=784, seed=0,
                            device=args.device)

    print("aggregator,malicious,dp,final_acc")
    out = {}
    for agg in AGGREGATORS:
        for dp in DP_NOISE:
            _, tr = run_cell(agg, dp, data, parts, args.device)
            out[(agg, dp)] = tr.accs[-1]
            print(f"{agg},0.25,{dp},{tr.accs[-1]:.3f}")
    return out


if __name__ == "__main__":
    main()
