"""Shared building blocks of the language models, as functions on tensors.

The JAX package's ``models/modules.py`` (and the depthwise causal
convolution it keeps in ``models/mamba.py``), with the same numerics:
RMSNorm reduces in float32 and multiplies in the activation dtype, RoPE
rotates the two halves of the head dim, and GeGLU's gelu is the tanh
approximation (``jax.nn.gelu``'s default).  Weights are (in, out) matrices
applied as ``x @ w``, the JAX package's layout.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F


def dense_init(shape: Sequence[int], generator: Optional[torch.Generator],
               *, scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Truncated-normal (±2 sigma) fan-in init, the JAX package's scheme
    (its draws differ: the port samples from ``generator``).  With no
    generator the tensor is left uninitialised, to be loaded."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(fan_in))
    t = torch.empty(tuple(shape), device=device)
    if generator is None:
        return t
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    ms = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    scale = torch.rsqrt(ms + eps).to(x.dtype)
    return x * scale * w.to(x.dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    the halves x[..., :hd/2] and x[..., hd/2:] (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def init_mlp(d_model: int, d_ff: int, generator: Optional[torch.Generator],
             *, device=None):
    return {"wg": dense_init((d_model, d_ff), generator, device=device),
            "wu": dense_init((d_model, d_ff), generator, device=device),
            "wd": dense_init((d_ff, d_model), generator, device=device)}


def mlp(p: Mapping[str, torch.Tensor], x: torch.Tensor,
        activation: str = "silu", shards=None) -> torch.Tensor:
    """Gated MLP: SwiGLU (``silu``) or GeGLU (``gelu``, tanh form).
    ``shards`` (a sharded training step): ``wg`` / ``wu`` hold this rank's
    d_ff columns and ``wd`` its rows, so the partial outputs are summed
    over the tensor-parallel axes."""
    gate = x @ p["wg"]
    gate = F.silu(gate) if activation == "silu" else F.gelu(
        gate, approximate="tanh")
    sh = share(shards)
    return sh.reduce((gate * (x @ p["wu"])) @ p["wd"], sh.axes("wd", 0))


def share(shards):
    """A block's share of a sharded training step
    (`repro_torch.core.sharding.Shards`), or, for None, the unsharded
    forward's (``NO_SHARDS``: every collective, chunk and relayout the
    identity), so one body serves both."""
    if shards is not None:
        return shards
    from ..core.sharding import NO_SHARDS   # core imports the models
    return NO_SHARDS


def sub_params(params: Mapping[str, torch.Tensor], prefix: str
               ) -> Dict[str, torch.Tensor]:
    """The entries of a flat parameter dict under ``prefix.``, without it
    (``layers.3.attn.wq`` -> ``attn.wq`` -> ``wq``)."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items()
            if k.startswith(prefix + ".")}


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal convolution.  x: (B,S,W), w: (K,W), b: (W,)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return out + b
