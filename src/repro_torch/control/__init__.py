"""Device-side control plane of the port: the Eqn-12 queue leaf and the
fixed / Lyapunov scan policies."""
from .policy import (CtlObs, ScanPolicy, fixed_policy, lyapunov_policy,
                     lyapunov_scores)
from .queue import per_slot_of

__all__ = ["CtlObs", "ScanPolicy", "fixed_policy", "lyapunov_policy",
           "lyapunov_scores", "per_slot_of"]
