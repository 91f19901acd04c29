"""Checked wrapper of the CUDA flash-attention kernel.

``flash_attention`` replaces the Pallas ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` (its ``_kernel``).  The kernel
lives in ``csrc/flash_attention.cu``; see the note there for what bounds it
on an H100 and how its design answers it.

Given CPU tensors the wrapper computes the plain version from `ref`.  Given
CUDA tensors it launches the kernel on the current stream or raises: there
is no fallback.  Each launch adds one to ``launches["flash_attention"]``.
"""
from __future__ import annotations

import ctypes

import torch

from .launch import P, current_stream, launches, raise_on, typed_library
from .ref import flash_attention_ref

SOURCE = "flash_attention.cu"
MAX_DIM = 256                   # largest head dim the kernel takes

_I, _F = ctypes.c_int, ctypes.c_float
_signatures = {name: [P, P, P, P, _I, _I, _I, _I, _I, _I, _F, _I, _F, P]
               for name in ("fa_forward_f32", "fa_forward_bf16")}


def _check(name, t, device, dtype, ndim=4):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} like q, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be (B, S, heads, dim), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Causal softmax attention, (B,S,H,d) x (B,S,Kv,d) x (B,S,Kv,dv) ->
    (B,S,H,dv), query head h reading K/V head h // (H / Kv).

    ``window > 0`` keeps keys j with i - window < j <= i; ``softcap > 0``
    caps the scaled scores at softcap * tanh(s / softcap).  float32 or
    bfloat16 (one type for all three); accumulates in float32 and returns
    q's type.  d and dv are at most 256.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, softcap=softcap)
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, dev, q.dtype)
    B, S, H, d = q.shape
    Kv, dv = k.shape[2], v.shape[3]
    if k.shape != (B, S, Kv, d) or v.shape[:3] != (B, S, Kv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit together")
    if Kv < 1 or H % Kv:
        raise ValueError(f"{H} query heads do not group over {Kv} K/V heads")
    if not (1 <= d <= MAX_DIM and 1 <= dv <= MAX_DIM):
        raise ValueError(f"head dims d={d}, dv={dv} outside 1..{MAX_DIM}")
    if B > 65535 or H > 65535:
        raise ValueError(f"batch {B} or heads {H} exceed the grid (65535)")
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = typed_library(SOURCE, _signatures)
    fn = (lib.fa_forward_f32 if q.dtype == torch.float32
          else lib.fa_forward_bf16)
    with torch.cuda.device(dev):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    B, S, H, Kv, d, dv, d ** -0.5, max(int(window), 0),
                    float(softcap), current_stream())
    raise_on(status, "flash_attention")
    launches["flash_attention"] += 1
    return out
