"""Named spec dicts the port is driven at on the card.

``PAPER_MLP_FLEET1K``: the paper's 784-200-10 MLP
(`repro/configs/paper_mnist.py`, §V) on a fleet of 1,024 devices in 16
clusters, 65,536 synthetic samples of width 784, trust aggregation and
Lyapunov control (budget 27,000 over a horizon of 60).  `chip_smoke.py`
and `scripts/port_profile.py` both build their federation from it.

``PAPER_ADAPTIVE_FLEET1K``: the same federation under the paper's full
scheme, a DQN pretrained on the DT environment picking each round's
local-step count (the controller of the JAX package's ``adaptive``
preset: 3 episodes of 20 steps).

``ANOMALY_FLEET1K``: the JAX package's ``autoencoder-anomaly`` task
(32-64-8-64-32 autoencoder on IoT telemetry of 8 device types, local
batch 32, lr 0.1) on the same fleet and sample count, under the
``adaptive`` preset's DQN, so the autoencoder's code mean feeds the DQN
observation.  The flat model is N = 5,288 floats.
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

# the JAX package's `adaptive` preset's controller
_ADAPTIVE_DQN = {"kind": "dqn", "params": {"episodes": 3, "horizon": 20}}

PAPER_ADAPTIVE_FLEET1K = {**PAPER_MLP_FLEET1K, "controller": _ADAPTIVE_DQN}

ANOMALY_FLEET1K = {
    "fleet": {"n_devices": 1024},
    "clustering": {"n_clusters": 16},
    "controller": _ADAPTIVE_DQN,
    "aggregator": {"kind": "trust"},
    "task": {"kind": "autoencoder-anomaly",
             "params": {"n_samples": 65536, "dim": 32, "n_types": 8,
                        "latent": 4, "anomaly_frac": 0.05, "noise": 0.05,
                        "hidden": 64, "code": 8}},
    "local_batch": 32, "lr": 0.1, "seed": 0,
}
