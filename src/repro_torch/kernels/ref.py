"""Plain PyTorch versions of the kernels.

Each function is the mathematical definition with no tiling: the CPU path
of the wrappers (`trust_aggregate`, `flash_attention`, `rglru_scan`,
`selective_scan`, and the population-batched `trust_aggregate_pop` and
`trust_aggregate_global_pop`), and what `chip_smoke.py` holds the CUDA
kernels against on the card.
Accumulation is in float32 and the result is cast to the input (or stack)
dtype, as the kernels do.  They match ``src/repro/kernels/ref.py``.
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


def trust_aggregate_pop_ref(params_flat, weights, mask=None):
    """`trust_aggregate_ref` of each of P federations at once: (P, C, N)
    x (P, C) [x (P, C) mask] -> (P, N)."""
    w = _effective_weights(weights, mask)
    out = (params_flat.to(torch.float32) * w[..., None]).sum(1)
    return out.to(params_flat.dtype)


def trust_aggregate_global_pop_ref(updates_flat, weights, mask, stack_flat,
                                   global_weights, c):
    """`trust_aggregate_global_ref` of each of P federations at once:
    (P, C, N) updates, (P, C) weights and mask, (P, B, N) stacks, (P, B)
    staleness weights and the (P,) rows ``c`` -> (P, N)."""
    agg = trust_aggregate_pop_ref(updates_flat.to(torch.float32), weights,
                                  mask)
    rows = torch.arange(stack_flat.shape[1], device=stack_flat.device)
    c = torch.as_tensor(c, device=stack_flat.device).reshape(-1, 1)
    s = torch.where((rows[None, :] == c)[..., None], agg[:, None, :],
                    stack_flat.to(torch.float32))
    gw = global_weights.to(torch.float32)
    return (s * gw[..., None]).sum(1).to(stack_flat.dtype)


NEG_INF = -2.0e38               # the masked score of the JAX package


def flash_attention_ref(q, k, v, *, window=0, softcap=0.0):
    """(B,S,H,d) x (B,S,Kv,d) x (B,S,Kv,dv) -> (B,S,H,dv): causal softmax
    attention with optional sliding window and tanh logit cap, query head
    h reading K/V head h // (H / Kv) (Kv = H is the JAX reference's case)."""
    B, S, H, d = q.shape
    Kv = k.shape[2]
    qg = q.to(torch.float32).reshape(B, S, Kv, H // Kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          k.to(torch.float32)) * (d ** -0.5)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.to(torch.float32))
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def rglru_scan_ref(a, bx):
    """Gated linear recurrence h_t = a_t * h_{t-1} + bx_t, state in f32.
    a, bx: (B,S,W) -> hs (B,S,W) in a's dtype, h_last (B,W) f32."""
    B, S, W = a.shape
    h = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    hs = torch.empty_like(a)
    for t in range(S):
        h = a[:, t].to(torch.float32) * h + bx[:, t].to(torch.float32)
        hs[:, t] = h
    return hs, h


def selective_scan_ref(xc, dt, Bc, Cc, A):
    """Mamba-1 recurrence h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,
    y_t = h_t C_t, state in f32.  xc, dt: (B,S,Di); Bc, Cc: (B,S,N);
    A: (Di,N) -> y (B,S,Di) in xc's dtype, h_last (B,Di,N) f32.  dt x is
    taken in the input dtype, then in f32, as the JAX oracle does."""
    B, S, Di = xc.shape
    h = torch.zeros((B, Di, A.shape[1]), dtype=torch.float32,
                    device=xc.device)
    y = torch.empty_like(xc)
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None].to(torch.float32) * A)
        dBx = (dt[:, t] * xc[:, t])[..., None].to(torch.float32) * \
            Bc[:, t, None, :].to(torch.float32)
        h = dA * h + dBx
        y[:, t] = torch.einsum("bdn,bn->bd", h,
                               Cc[:, t].to(torch.float32)).to(xc.dtype)
    return y, h
