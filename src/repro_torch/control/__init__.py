"""Device-side control plane of the port: the Eqn-12 queue leaf, the
fixed / Lyapunov / DQN / table scan policies and the DQN's pretraining on
the DT environment."""
from .policy import (CtlObs, PolicyTable, ScanPolicy, deploy_obs,
                     distill_table, dqn_policy, fixed_policy,
                     lyapunov_policy, lyapunov_scores, table_policy)
from .queue import per_slot_of
from .scanned_dqn import episode_step, train_on_env

__all__ = ["CtlObs", "ScanPolicy", "fixed_policy", "lyapunov_policy",
           "lyapunov_scores", "per_slot_of", "dqn_policy", "deploy_obs",
           "distill_table", "table_policy", "PolicyTable", "train_on_env",
           "episode_step"]
