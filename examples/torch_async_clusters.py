"""Straggler elimination via clustering (paper Figs 6/7) on the PyTorch/CUDA
port: sweep the number of K-means clusters through the unified API and
report accuracy against simulated time.  The spec is data: the sweep is
four dataclass replaces.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_async_clusters.py [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.api import (ControllerSpec, Federation, FederationSpec,
                             FleetSpec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    base = FederationSpec(
        fleet=FleetSpec(n_devices=16),
        controller=ControllerSpec("fixed", {"a": 5}),
        sim_seconds=15.0,
        local_batch=64,
        seed=0,
    )

    print("clusters,final_acc,aggregations,energy")
    out = {}
    for k in [1, 2, 4, 8]:
        spec = base.replace(clustering=dataclasses.replace(
            base.clustering, n_clusters=k))
        fed = Federation.from_spec(spec, device=args.device)
        tr = fed.run(eval_every=3.0)
        out[k] = tr.accs[-1]
        print(f"{k},{tr.accs[-1]:.3f},{fed.agg_count},{fed.energy_used:.1f}")
    return out


if __name__ == "__main__":
    main()
