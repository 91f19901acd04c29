"""Client-level differential privacy for federated updates, on flat rows.

Privacy is the paper's stated motivation for FL in Industrial IoT (§I:
"data islands ... privacy and security issues"); the mechanism is the
standard one:

    clip each client's model delta to L2 <= clip, then add
    N(0, (noise * clip / n_clients)^2) to the aggregate.

A copy of the JAX package's ``repro.core.privacy`` over the port's flat
(M, N) rows: the JAX package's global norm over all leaves of a client's
update is the norm of its flat row.  The Eqn-6 weighted sum of the clipped
deltas goes through the masked `trust_aggregate` kernel.  Drawing stays
apart from using: the N standard normals are an argument.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.trust_aggregate import trust_aggregate


def clip_update(update: torch.Tensor, clip: float) -> torch.Tensor:
    """Scale one (N,) update to L2 norm <= ``clip``."""
    return clip_client_updates(update[None], clip)[0]


def clip_client_updates(updates: torch.Tensor, clip: float) -> torch.Tensor:
    """Clip each row of an (M, N) matrix of updates to L2 norm <= ``clip``."""
    norm = torch.sqrt(torch.square(updates.to(torch.float32)).sum(1))
    scale = torch.clamp(clip / (norm + 1e-12), max=1.0)
    return updates * scale[:, None].to(updates.dtype)


def dp_aggregate(deltas: torch.Tensor, weights: torch.Tensor,
                 mask: torch.Tensor, cur: torch.Tensor, clip: float,
                 noise: float, n_clients, normals: torch.Tensor
                 ) -> torch.Tensor:
    """Eqn 6 under client-level DP: ``cur`` plus the noised weighted sum of
    the clipped (M, N) ``deltas``.

    The sum ``sum_c w_c m_c clip(x_c)`` is one launch of the masked
    `trust_aggregate` kernel; ``normals`` (N,) are the standard normals of
    the Gaussian mechanism, scaled by ``noise * clip / max(n_clients, 1)``
    (``n_clients`` may be a 0-d tensor: the true member count of a padded
    round).  -> the (N,) new cluster model.
    """
    clipped = clip_client_updates(deltas, clip)
    agg = trust_aggregate(clipped.contiguous(), weights.to(torch.float32),
                          mask.to(torch.float32))
    n = torch.clamp(torch.as_tensor(n_clients, dtype=torch.float32,
                                    device=agg.device), min=1.0)
    sigma = noise * clip / n
    return cur.to(torch.float32) + (agg + sigma * normals)
