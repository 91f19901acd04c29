"""Griffin RG-LRU recurrent block (recurrentgemma-2b).

Block: x -> [W_x -> causal conv -> RG-LRU] * gelu(W_gate x) -> W_out.
RG-LRU (Real-Gated Linear Recurrent Unit):
    r_t = sigmoid(x W_a + b_a)            recurrence gate
    i_t = sigmoid(x W_i + b_i)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
The gates are dense products left to PyTorch; the recurrence over the
sequence is one launch of the RG-LRU scan kernel (`kernels.ops.lru_scan`),
with a and bx in float32 as in the JAX package's ``models/rglru.py``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ArchConfig
from .modules import causal_conv, dense_init, share

_C = 8.0


def init_rglru(cfg: ArchConfig, generator: Optional[torch.Generator], *,
               device=None) -> Dict[str, torch.Tensor]:
    D, W, K = cfg.d_model, cfg.lru_width, cfg.ssm_conv
    kw = dict(device=device)
    return {
        "w_x": dense_init((D, W), generator, **kw),
        "w_gate": dense_init((D, W), generator, **kw),
        "conv_w": dense_init((K, W), generator, scale=0.5, **kw),
        "conv_b": torch.zeros((W,), **kw),
        "w_a": dense_init((W, W), generator, **kw),
        "b_a": torch.zeros((W,), **kw),
        "w_i": dense_init((W, W), generator, **kw),
        "b_i": torch.zeros((W,), **kw),
        # softplus(lam) spans the decay rates
        "lam": torch.linspace(0.9, 5.0, W, **kw),
        "w_out": dense_init((W, D), generator, **kw),
    }


def _gates(p, xc):
    """-> (a, sqrt(1 - a^2) * i), both float32."""
    r = torch.sigmoid((xc @ p["w_a"]).to(torch.float32) + p["b_a"])
    i = torch.sigmoid((xc @ p["w_i"]).to(torch.float32) + p["b_i"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, beta * i


def rglru_forward(p, cfg: ArchConfig, x, return_state: bool = False,
                  shards=None):
    """x: (B,S,D) -> (B,S,D) [, decode cache {"h", "conv"}].

    ``shards`` (a sharded training step): the rank holds its channels of
    ``w_x``, ``w_gate``, the convolution, the gates' columns and Lambda,
    and its rows of ``w_out``; the gates read every channel (one
    all-gather of the convolution's output), the scan runs on the rank's
    own, and the partial outputs are summed."""
    B, S, _ = x.shape
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    xin = x @ p["w_x"]
    xr = causal_conv(xin, p["conv_w"], p["conv_b"])
    sh = share(shards)
    ax = sh.axes("w_x", 1)
    a, bi = _gates(p, sh.gather(xr, -1, ax))               # (B,S,W) f32
    hs, h_last = ops.lru_scan(a, bi * xr.to(torch.float32))
    y = hs.to(x.dtype) * gate
    out = sh.reduce(y @ p["w_out"], ax)
    if not return_state:
        return out
    K = cfg.ssm_conv
    conv_tail = xin[:, max(0, S - (K - 1)):, :]
    if S < K - 1:
        conv_tail = F.pad(conv_tail, (0, 0, K - 1 - S, 0))
    return out, {"h": h_last, "conv": conv_tail}


def init_rglru_cache(cfg: ArchConfig, batch: int, device=None):
    return {
        "h": torch.zeros((batch, cfg.lru_width), device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.lru_width),
                            device=device),
    }


def rglru_decode(p, cfg: ArchConfig, x, cache, step: int):
    """x: (B,1,D) one-token step -> (y, cache); the cache dict is updated
    in place with the new state and conv history."""
    gate = F.gelu(x[:, 0] @ p["w_gate"], approximate="tanh")
    xin = x[:, 0] @ p["w_x"]
    hist = torch.cat([cache["conv"], xin[:, None].to(cache["conv"].dtype)],
                     dim=1)
    xr = torch.einsum("bkw,kw->bw", hist.to(x.dtype), p["conv_w"]) \
        + p["conv_b"]
    a, bi = _gates(p, xr)
    h = a * cache["h"] + bi * xr.to(torch.float32)
    y = (h.to(x.dtype) * gate) @ p["w_out"]
    cache["h"], cache["conv"] = h, hist[:, 1:]
    return y[:, None], cache
