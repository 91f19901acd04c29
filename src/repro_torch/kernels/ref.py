"""Plain PyTorch versions of the trust-aggregation kernels.

Each function is the mathematical definition with no tiling: the CPU path
of the wrappers in `trust_aggregate`, and what `chip_smoke.py` holds the
CUDA kernels against on the card.  Accumulation is in float32 and the
result is cast to the input (or stack) dtype, as the kernels do.
"""
from __future__ import annotations

import torch


def _effective_weights(weights, mask):
    w = weights.to(torch.float32)
    if mask is not None:
        w = w * mask.to(torch.float32)
    return w


def trust_aggregate_ref(params_flat, weights, mask=None):
    """Eqn 6: (C, N) x (C,) -> (N,), optionally masking padded rows.

    A masked-out row contributes exactly zero even when it holds 1e30
    (0 * 1e30 == 0) or when the caller left a weight on it."""
    w = _effective_weights(weights, mask)
    out = (params_flat.to(torch.float32) * w[:, None]).sum(0)
    return out.to(params_flat.dtype)


def trust_aggregate_global_ref(updates_flat, weights, mask, stack_flat,
                               global_weights, c):
    """Fused Eqn 6 + Eqn 19: the masked Eqn-6 aggregate of the (C, N)
    member updates replaces row ``c`` of the (B, N) cluster stack, then the
    (B,) staleness-weighted sum gives the (N,) global vector."""
    agg = trust_aggregate_ref(updates_flat.to(torch.float32), weights, mask)
    rows = torch.arange(stack_flat.shape[0], device=stack_flat.device)
    c = torch.as_tensor(c, device=stack_flat.device)
    s = torch.where((rows == c)[:, None], agg[None, :],
                    stack_flat.to(torch.float32))
    gw = global_weights.to(torch.float32)
    return (s * gw[:, None]).sum(0).to(stack_flat.dtype)
