"""Mamba-1 selective state-space block (falcon-mamba-7b).

Block: x -> in_proj -> (xin, z); xin -> causal conv -> silu -> xc;
(dt, B, C) from xc; y = selective_scan(xc, dt, B, C, A) + D xc;
out = (y * silu(z)) @ out_proj, with A = -exp(A_log).  The projections are
dense products left to PyTorch; the recurrence over the sequence is one
launch of the selective-scan kernel (`kernels.ops.mamba_scan`), where the
JAX package's ``models/mamba.py`` runs a ``lax.scan``.  Decode is one
recurrence step in plain PyTorch, as in the JAX package, with an O(1)
state: the (B, Di, N) SSM state and the (B, K-1, Di) conv history, both
float32.

The block trains: autograd reaches every parameter (``in_proj``,
``conv_w``, ``conv_b``, ``x_proj``, ``dt_proj``, ``dt_bias``, ``A_log``
through A, ``D``, ``out_proj``), through the PyTorch ops and, for the scan,
the backward kernel (`kernels.selective_scan_bwd`; on the CPU its plain
version), as the JAX package's training differentiates its ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ArchConfig
from .modules import causal_conv, dense_init, share


def init_mamba(cfg: ArchConfig, generator: Optional[torch.Generator], *,
               device=None) -> Dict[str, torch.Tensor]:
    D, Di, N, R, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.ssm_conv)
    kw = dict(device=device)
    A = torch.arange(1, N + 1, dtype=torch.float32, **kw).expand(Di, N)
    return {
        "in_proj": dense_init((D, 2 * Di), generator, **kw),
        "conv_w": dense_init((K, Di), generator, scale=0.5, **kw),
        "conv_b": torch.zeros((Di,), **kw),
        "x_proj": dense_init((Di, R + 2 * N), generator, **kw),
        "dt_proj": dense_init((R, Di), generator, **kw),
        "dt_bias": torch.zeros((Di,), **kw),
        "A_log": torch.log(A),
        "D": torch.ones((Di,), **kw),
        "out_proj": dense_init((Di, D), generator, **kw),
    }


def _ssm_params(p, cfg: ArchConfig, xc, shards=None):
    """xc: (..., Di) conv output -> (dt, B, C) selective parameters; dt in
    the activation dtype.  ``shards``: ``x_proj`` holds this rank's rows,
    so its partial product is summed first."""
    sh = share(shards)
    dbc = sh.reduce(xc @ p["x_proj"], sh.axes("x_proj", 0))
    dt_r, Bc, Cc = torch.split(dbc, [cfg.dt_rank, cfg.ssm_state,
                                     cfg.ssm_state], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"]).to(xc.dtype)
    return dt, Bc, Cc


def mamba_forward(p, cfg: ArchConfig, x, return_state: bool = False,
                  shards=None):
    """x: (B,S,D) -> (B,S,D) [, decode cache {"h", "conv"}].

    ``shards`` (a sharded training step): ``in_proj``'s columns split the
    concatenated (x, z) dims, so its output is gathered and each rank
    keeps its channels of both halves; the convolution, ``dt_proj``,
    ``A_log``, ``D`` and the scan run on those channels, and ``x_proj``'s
    and ``out_proj``'s partial products are summed."""
    S = x.shape[1]
    sh = share(shards)
    ax = sh.axes("in_proj", 1)
    xin, z = sh.gather(x @ p["in_proj"], -1, ax).chunk(2, dim=-1)
    xin, z = sh.chunk(xin, -1, ax), sh.chunk(z, -1, ax)
    xc = F.silu(causal_conv(xin, p["conv_w"], p["conv_b"]))
    dt, Bc, Cc = _ssm_params(p, cfg, xc, sh)           # (B,S,Di) (B,S,N) x2
    A = -torch.exp(p["A_log"])                          # (Di,N)
    ys, h_last = ops.mamba_scan(xc, dt, Bc, Cc, A)
    y = ys + xc * p["D"].to(x.dtype)
    y = (y * F.silu(z)).to(x.dtype)
    out = sh.reduce(y @ p["out_proj"], sh.axes("out_proj", 0))
    if not return_state:
        return out
    K = cfg.ssm_conv
    conv_tail = xin[:, max(0, S - (K - 1)):, :]
    if S < K - 1:
        conv_tail = F.pad(conv_tail, (0, 0, K - 1 - S, 0))
    return out, {"h": h_last, "conv": conv_tail.contiguous()}


def init_mamba_cache(cfg: ArchConfig, batch: int, device=None):
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state), device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            device=device),
    }


def mamba_decode(p, cfg: ArchConfig, x, cache, step: int, shards=None):
    """x: (B,1,D) one-token step -> (y, cache); the cache dict is updated
    in place with the new state and conv history.  ``shards`` (sharded
    serving): the rank's channels of ``h`` and ``conv`` (``state_axis``)
    and of the parameters, as in `mamba_forward`: ``in_proj``'s output is
    gathered and cut to the rank's channels of both halves, and
    ``x_proj``'s and ``out_proj``'s partial products are summed."""
    sh = share(shards)
    ax = sh.axes("in_proj", 1)
    xin, z = sh.gather(x[:, 0] @ p["in_proj"], -1, ax).chunk(2, dim=-1)
    xin, z = sh.chunk(xin, -1, ax), sh.chunk(z, -1, ax)   # (B,Di)
    hist = torch.cat([cache["conv"], xin[:, None].to(cache["conv"].dtype)],
                     dim=1)
    xc = F.silu(torch.einsum("bkd,kd->bd", hist.to(x.dtype), p["conv_w"])
                + p["conv_b"])
    dt, Bc, Cc = _ssm_params(p, cfg, xc, sh)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xc)[..., None] * Bc[:, None, :]
    h = dA * cache["h"] + dBx.to(torch.float32)
    y = torch.einsum("bdn,bn->bd", h, Cc.to(torch.float32)).to(x.dtype)
    y = ((y + xc * p["D"].to(x.dtype)) * F.silu(z)).to(x.dtype)
    cache["h"], cache["conv"] = h, hist[:, 1:]
    return sh.reduce(y @ p["out_proj"], sh.axes("out_proj", 0))[:, None], \
        cache
