"""Adaptive aggregation frequency (paper Figs 4/5/8) on the PyTorch/CUDA
port: the DQN+Lyapunov agent against fixed frequencies under a resource
budget in a time-varying channel, with every federation in
``execution="scanned"``: K asynchronous cluster rounds, the controller's
choice and the Eqn-12 deficit queue on the device, the metrics read back
once.  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_adaptive_frequency.py [--device cpu]
"""
import argparse

import repro_torch.api as api
from repro_torch.api import (ControllerSpec, Federation, FederationSpec,
                             FleetSpec)

ROUNDS = 40

BASE = FederationSpec(
    fleet=FleetSpec(n_devices=16, dt_max_dev=0.2),
    clustering=api.ClusteringSpec(n_clusters=4),
    channel=api.ChannelSpec(p_good=0.4),
    task=api.TaskSpec("mlp", {"n_samples": 2048, "dim": 64}),
    execution="scanned", rounds=ROUNDS,
    sim_seconds=1e9, local_batch=32, seed=0)


def run(name: str, controller: ControllerSpec, device=None):
    trace = Federation.from_spec(BASE.replace(controller=controller),
                                 device=device).run()
    final = trace.records[-1]                   # the appended eval record
    print(f"{name},{final.loss:.4f},{final.acc:.3f},{final.energy:.1f}")
    return trace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    print(f"scheme,final_loss,final_acc,energy   ({ROUNDS} scanned rounds)")
    out = {"dqn_adaptive": run(
        "dqn_adaptive", ControllerSpec("dqn", {"episodes": 4, "horizon": 25,
                                               "p_good": 0.4}), args.device)}
    out["lyapunov_greedy"] = run(
        "lyapunov_greedy",
        ControllerSpec("lyapunov", {"budget": 400.0, "horizon": ROUNDS}),
        args.device)
    for a in (1, 3, 5, 10):
        out[f"fixed_{a}"] = run(f"fixed_{a}", ControllerSpec("fixed",
                                                             {"a": a}),
                                args.device)
    return out


if __name__ == "__main__":
    main()
