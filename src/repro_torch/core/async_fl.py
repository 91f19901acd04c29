"""The legacy entry point of the paper's experiments, over the port's API.

The port's copy of the JAX package's ``repro.core.async_fl``: the paper's
asynchronous clustered orchestrator (§IV-D, Alg. 2) is
`repro_torch.api.engine.DeviceScaleEngine`, and `AsyncFederation` and
`run_sync_baseline` are thin wrappers that translate a legacy
`AsyncFLConfig` into a `FederationSpec` (`repro_torch.api.legacy_spec`)
and delegate, so both entry points give identical traces at the same seed.
The paper's figures (`repro_torch.paper`) drive this surface.  New code
should use:

    from repro_torch.api import Federation, FederationSpec
    trace = Federation.from_spec(FederationSpec(...)).run()

Like every entry point of the port, it runs on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.api.records import FLTrace

from . import dqn as dqn_lib

__all__ = ["AsyncFLConfig", "AsyncFederation", "FLTrace",
           "run_sync_baseline"]


@dataclasses.dataclass
class AsyncFLConfig:
    n_devices: int = 16
    n_clusters: int = 4
    local_batch: int = 64
    sim_seconds: float = 60.0        # simulated wall-clock budget
    alpha0: float = 0.5              # tolerance factor (grows with rounds)
    alpha_growth: float = 0.02
    iota: float = 0.1                # Eqn 5 uncertainty coefficient
    pkt_fail: float = 0.05
    p_good: float = 0.5
    malicious_frac: float = 0.0
    dt_max_dev: float = 0.2
    calibrate_dt: bool = True
    lr: float = 0.1
    seed: int = 0
    fixed_frequency: Optional[int] = None   # not None => benchmark scheme
    aggregator: str = "trust"   # trust | fedavg | krum | multi_krum |
                                # median | trimmed_mean (robust baselines)
    dp_clip: float = 0.0        # >0: client-level DP clipping norm
    dp_noise: float = 0.0       # DP noise multiplier


class AsyncFederation:
    """Thin wrapper over `DeviceScaleEngine` (prefer
    ``repro_torch.api.Federation``).  ``agent`` (a trained DQN) picks the
    per-cluster frequencies; ``cfg.fixed_frequency`` selects the benchmark
    scheme; with neither, every round runs a = 5.  ``data`` and ``parts``
    are the task's dataset and its per-device index arrays
    (`repro_torch.paper.fed_setup`)."""

    def __init__(self, cfg: AsyncFLConfig, data, parts,
                 agent: Optional[dqn_lib.DQNState] = None,
                 dqn_cfg: Optional[dqn_lib.DQNConfig] = None, *,
                 device=None):
        from repro_torch.api import (DQNController, Federation,
                                     FixedController, legacy_spec)
        self.cfg = cfg
        self.dqn_cfg = dqn_cfg or dqn_lib.DQNConfig()
        spec = legacy_spec(cfg)
        if cfg.fixed_frequency is not None:
            controller = FixedController(cfg.fixed_frequency,
                                         n_actions=self.dqn_cfg.n_actions)
        elif agent is not None:
            controller = DQNController(agent, self.dqn_cfg)
        else:
            controller = FixedController(5, n_actions=self.dqn_cfg.n_actions)
        self.agent = agent
        self._fed = Federation.from_spec(spec, data=data, parts=parts,
                                         controller=controller,
                                         device=device)

    def run(self, eval_every: float = 1.0) -> FLTrace:
        return self._fed.run(eval_every=eval_every)

    def __getattr__(self, name):
        if name == "_fed":                   # not yet set: avoid recursion
            raise AttributeError(name)
        return getattr(self._fed.engine, name)


def run_sync_baseline(cfg: AsyncFLConfig, data, parts, *,
                      device=None) -> FLTrace:
    """The benchmark scheme: synchronous FedAvg at a fixed frequency — one
    cluster, fixed a, every round gated on the slowest device."""
    sync = dataclasses.replace(cfg, n_clusters=1,
                               fixed_frequency=cfg.fixed_frequency or 5)
    return AsyncFederation(sync, data, parts, device=device).run()
