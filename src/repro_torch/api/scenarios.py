"""Named spec dicts the port is driven at on the card.

``PAPER_MLP_FLEET1K``: the paper's 784-200-10 MLP
(`repro/configs/paper_mnist.py`, §V) on a fleet of 1,024 devices in 16
clusters, 65,536 synthetic samples of width 784, trust aggregation and
Lyapunov control (budget 27,000 over a horizon of 60).  `chip_smoke.py`
and `scripts/port_profile.py` both build their federation from it.
"""
from __future__ import annotations

PAPER_MLP_FLEET1K = {
    "fleet": {"n_devices": 1024},
    "clustering": {"n_clusters": 16},
    "controller": {"kind": "lyapunov",
                   "params": {"budget": 27000, "horizon": 60}},
    "aggregator": {"kind": "trust"},
    "task": {"kind": "mlp", "params": {"n_samples": 65536, "dim": 784,
                                       "hidden": 200, "n_classes": 10}},
    "local_batch": 64, "lr": 0.1, "seed": 0,
}
