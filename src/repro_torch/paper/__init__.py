"""The paper's own evaluation on the port: Figs 2-8 and the robustness
grid, through the legacy entry point (`repro_torch.core.AsyncFederation`)
and the population engine.

  common      `timed`, `train_dqn_agent` (Alg. 1 on the DT environment),
              `fed_setup` (the synthetic MNIST-shaped task, partitioned)
  figures     `fig2_dqn_convergence` ... `fig8_adaptive_vs_fixed`, `ALL`
  robustness  the (fault mode x aggregator) grid, each fault mode one
              B = 2 population beside its sequential runs
  __main__    ``python -m repro_torch.paper [--quick] [--device cpu]``

The counterparts of the JAX package's ``benchmarks/{common,figures,
attack_bench,run}.py``, at the same protocols and seeds.
"""
from .common import fed_setup, sync, timed, train_dqn_agent

__all__ = ["fed_setup", "sync", "timed", "train_dqn_agent"]
