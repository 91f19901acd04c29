"""Quickstart on the PyTorch/CUDA port: the paper's full pipeline through
the unified API.

One declarative `FederationSpec` drives everything: digital twins of a
heterogeneous device fleet -> K-means clustering -> DQN aggregation-frequency
agent (trained on the DT-simulated environment, §IV-C: the agent interacts
with the twins, not the devices) -> asynchronous clustered federated learning
with trust-weighted aggregation (the fused CUDA kernel every round) on a
synthetic MNIST-shaped task.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

from repro_torch.api import (ClusteringSpec, ControllerSpec, Federation,
                             FederationSpec, FleetSpec)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    spec = FederationSpec(
        fleet=FleetSpec(n_devices=16, malicious_frac=0.125),
        clustering=ClusteringSpec(n_clusters=4),
        # the registry factory pretrains an Alg.-1 DQN on the DT env
        controller=ControllerSpec("dqn", {"episodes": 4, "horizon": 30,
                                          "seed": 0}),
        sim_seconds=20.0,
        local_batch=64,
        seed=0,
    )
    print("spec:", {k: v for k, v in spec.to_dict().items()
                    if k in ("scale", "sim_seconds", "seed")})

    fed = Federation.from_spec(spec, device=args.device)   # data built in
    trace = fed.run(eval_every=2.0)

    for r in trace.records:
        print(f"t={r.t:5.1f}s  round={r.round:3d}  a={r.a}  "
              f"acc={r.acc:.3f}  loss={r.loss:.3f}")
    print(f"aggregations: {fed.agg_count}, energy: {fed.energy_used:.1f}")

    rep = fed.state.rep.cpu().tolist()
    print("reputation (malicious flagged *):")
    for i, r in enumerate(rep):
        print(f"  device {i:2d}: {r:7.2f}{' *' if fed.malicious[i] else ''}")
    return fed, trace


if __name__ == "__main__":
    main()
