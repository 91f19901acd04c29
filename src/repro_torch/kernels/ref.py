"""Plain PyTorch versions of the kernels.

Each function is the mathematical definition with no tiling: the CPU path
of the wrappers (`trust_aggregate`, `flash_attention`, `rglru_scan`,
`selective_scan`, and the population-batched `trust_aggregate_pop` and
`trust_aggregate_global_pop`), and what `chip_smoke.py` holds the CUDA
kernels against on the card.  The three backward versions
(`flash_attention_bwd_ref`, `rglru_scan_bwd_ref`,
`selective_scan_bwd_ref`) compute the gradient formulas directly, as the
backward kernels do; the JAX package has no backward kernel, and its
reference is ``jax.grad`` of the jnp layers.
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


def _attention_scores(q, k, window, softcap):
    """-> (the capped, masked scores (B, Kv, g, S, S) in float32, tanh of
    the capped ones (None without a cap), the mask (S, S))."""
    B, S, H, d = q.shape
    Kv = k.shape[2]
    qg = q.to(torch.float32).reshape(B, S, Kv, H // Kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg,
                          k.to(torch.float32)) * (d ** -0.5)
    th = None
    if softcap > 0:
        th = torch.tanh(scores / softcap)
        scores = th * softcap
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    return torch.where(mask, scores, NEG_INF), th, mask


def flash_attention_ref(q, k, v, *, window=0, softcap=0.0):
    """(B,S,H,d) x (B,S,Kv,d) x (B,S,Kv,dv) -> (B,S,H,dv): causal softmax
    attention with optional sliding window and tanh logit cap, query head
    h reading K/V head h // (H / Kv) (Kv = H is the JAX reference's case)."""
    return flash_attention_lse_ref(q, k, v, window=window,
                                   softcap=softcap)[0]


def flash_attention_lse_ref(q, k, v, *, window=0, softcap=0.0):
    """`flash_attention_ref` and each query row's log-sum-exp of its
    masked scores, (B, H, S) float32: the forward kernel's lse output."""
    B, S, H, _ = q.shape
    scores, _, _ = _attention_scores(q, k, window, softcap)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.to(torch.float32))
    lse = torch.logsumexp(scores, dim=-1).reshape(B, H, S)
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, lse, dout, *, window=0,
                            softcap=0.0):
    """The gradient of `flash_attention_ref` by its formulas, in float32:
    p = exp(s - lse), dS = p (dO . v - rowsum(dO o)), times (1 - tanh^2)
    of the capped score under a cap; dQ = scale dS k, dK = scale dS^T q
    (summed over a group's query heads), dV = p^T dO.  -> (dq, dk, dv)
    in the shapes and types of q, k, v (bfloat16 inputs are upcast)."""
    B, S, H, d = q.shape
    Kv, dv = k.shape[2], v.shape[3]
    g = H // Kv
    scale = d ** -0.5
    scores, th, mask = _attention_scores(q, k, window, softcap)
    L = lse.to(torch.float32).reshape(B, Kv, g, S, 1)
    p = torch.where(mask, torch.exp(scores - L), 0.0)
    do = dout.to(torch.float32).reshape(B, S, Kv, g, dv)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.to(torch.float32))
    delta = (dout.to(torch.float32) * o.to(torch.float32)).sum(-1)
    delta = delta.reshape(B, S, Kv, g).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - delta)
    if th is not None:
        ds = ds * (1.0 - th * th)
    qg = q.to(torch.float32).reshape(B, S, Kv, g, d)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(torch.float32)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dvv = torch.einsum("bkgst,bskgd->btkd", p, do)
    return (dq.reshape(B, S, H, d).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))


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


def rglru_scan_bwd_ref(a, hs, dhs, dh_last):
    """The gradient of `rglru_scan_ref` by its reverse recurrence, in
    float32: g_t = dhs_t + a_{t+1} g_{t+1}, g_{S-1} = dhs_{S-1} + dh_last;
    d bx_t = g_t, d a_t = g_t h_{t-1} (h_{-1} = 0).  a, hs, dhs: (B,S,W);
    dh_last: (B,W) -> (da, dbx) (B,S,W) in a's type (bfloat16 inputs are
    upcast)."""
    S, dtype = a.shape[1], a.dtype
    a, hs, dhs = (x.to(torch.float32) for x in (a, hs, dhs))
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    g = dh_last.to(torch.float32)
    for t in range(S - 1, -1, -1):
        g = dhs[:, t] + (a[:, t + 1] * g if t + 1 < S else g)
        dbx[:, t] = g
        da[:, t] = g * hs[:, t - 1] if t > 0 else 0.0
    return da.to(dtype), dbx.to(dtype)


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


def selective_scan_chunk_states_ref(xc, dt, Bc, Cc, A, chunk: int = 32):
    """The state of `selective_scan_ref` entering each chunk of ``chunk``
    steps: (ceil(S / chunk), B, N, Di) float32, chunk k's the state after
    steps 0 .. k chunk - 1 (chunk 0's zero), as the forward kernel's
    states output lays it out for the backward."""
    B, S, Di = xc.shape
    h = torch.zeros((B, Di, A.shape[1]), dtype=torch.float32,
                    device=xc.device)
    out = torch.empty((-(-S // chunk), B, A.shape[1], Di),
                      dtype=torch.float32, device=xc.device)
    for t in range(S):
        if t % chunk == 0:
            out[t // chunk] = h.transpose(1, 2)
        dA = torch.exp(dt[:, t, :, None].to(torch.float32) * A)
        dBx = (dt[:, t] * xc[:, t])[..., None].to(torch.float32) * \
            Bc[:, t, None, :].to(torch.float32)
        h = dA * h + dBx
    return out


def selective_scan_bwd_ref(xc, dt, Bc, Cc, A, dy, dh_last=None):
    """The gradient of `selective_scan_ref` by its reverse recurrence, in
    float32.  The states h_t are recomputed as the forward computes them;
    then, from t = S-1 down to 0, with dA_t = exp(dt_t A):

      g_t    = dy_t C_t + dA_{t+1} g_{t+1}    (+ dh_last at t = S-1)
      dCc_t  = sum_d dy_t h_t,     dBc_t = sum_d g_t dt_t x_t,
      dxc_t  = dt_t sum_n g_t B_t,
      ddt_t  = x_t sum_n g_t B_t + sum_n g_t A dA_t h_{t-1},
      dA     = sum_{b,t} g_t dt_t dA_t h_{t-1}        (h_{-1} = 0).

    xc, dt, dy: (B,S,Di); Bc, Cc: (B,S,N); A: (Di,N); dh_last: (B,Di,N) or
    None (no gradient reaches the final state) -> (dxc, ddt, dBc, dCc, dA)
    in the shapes and types of the inputs."""
    B, S, Di = xc.shape
    x, d, b, c, a, gy = (t.to(torch.float32) for t in (xc, dt, Bc, Cc, A, dy))
    hs = torch.empty((S, B, Di, a.shape[1]), dtype=torch.float32,
                     device=xc.device)
    h = torch.zeros_like(hs[0])
    for t in range(S):
        h = torch.exp(d[:, t, :, None] * a) * h + \
            (d[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        hs[t] = h
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.zeros_like(a)
    g = (torch.zeros_like(h) if dh_last is None
         else dh_last.to(torch.float32).clone())
    decay_next = None                       # dA_{t+1}
    for t in range(S - 1, -1, -1):
        decay = torch.exp(d[:, t, :, None] * a)
        g = gy[:, t, :, None] * c[:, t, None, :] + (
            g if decay_next is None else decay_next * g)
        dc[:, t] = torch.einsum("bdn,bd->bn", hs[t], gy[:, t])
        db[:, t] = torch.einsum("bdn,bd->bn", g, d[:, t] * x[:, t])
        gb = torch.einsum("bdn,bn->bd", g, b[:, t])
        dx[:, t] = d[:, t] * gb
        u = g * decay * (hs[t - 1] if t > 0 else 0.0)
        ddt[:, t] = x[:, t] * gb + (u * a).sum(-1)
        da += (u * d[:, t, :, None]).sum(0)
        decay_next = decay
    return (dx.to(xc.dtype), ddt.to(dt.dtype), db.to(Bc.dtype),
            dc.to(Cc.dtype), da.to(A.dtype))
