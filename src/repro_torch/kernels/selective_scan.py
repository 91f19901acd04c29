"""Checked wrapper of the CUDA Mamba-1 selective-scan kernel (falcon-mamba-7b).

``selective_scan`` replaces the Pallas ``selective_scan`` of
``src/repro/kernels/selective_scan.py`` (its ``_kernel``).  The kernel
lives in ``csrc/selective_scan.cu``; see the note there for what bounds it
on an H100 and how its design answers it.

Given CPU tensors the wrapper computes the plain version from `ref`.  Given
CUDA tensors it launches the kernel on the current stream or raises: there
is no fallback.  Each launch adds one to ``launches["selective_scan"]``.

The kernel has no backward yet (ROADMAP queue 1, item 10: the
``selective_scan`` backward kernel and falcon-mamba training).  On the card
a call that autograd would need to differentiate (grad enabled and an
input requires a gradient) raises rather than return an output autograd
cannot see; on the CPU the plain version is differentiable.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .launch import P, current_stream, launches, raise_on, typed_library
from .ref import selective_scan_ref

SOURCE = "selective_scan.cu"
MAX_STATE = 64                  # largest N the kernel takes

_I = ctypes.c_int
_signatures = {name: [P, P, P, P, P, P, P, _I, _I, _I, _I, P]
               for name in ("selective_scan_f32", "selective_scan_bf16")}


def selective_scan(xc: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 recurrence h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,
    y_t = h_t C_t, h_{-1} = 0.  xc, dt: (B,S,Di); Bc, Cc: (B,S,N);
    A: (Di,N) float32 -> (y (B,S,Di) in xc's type, h_last (B,Di,N) f32).

    xc, dt, Bc and Cc are float32 or bfloat16, all one type; the state is
    carried in float32.  N is at most 64.
    """
    if xc.device.type == "cpu":
        return selective_scan_ref(xc, dt, Bc, Cc, A)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, dt, Bc, Cc, A)):
        raise NotImplementedError(
            "selective_scan has no backward kernel yet (ROADMAP queue 1, "
            "item 10): run it under torch.no_grad() or with inputs that "
            "need no gradient")
    dev = xc.device
    if xc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"xc must be float32 or bfloat16, got {xc.dtype}")
    if xc.dim() != 3 or Bc.dim() != 3 or A.dim() != 2:
        raise ValueError(f"expected xc (B,S,Di), Bc (B,S,N) and A (Di,N), "
                         f"got {tuple(xc.shape)}, {tuple(Bc.shape)} and "
                         f"{tuple(A.shape)}")
    B, S, Di = xc.shape
    N = A.shape[1]
    shapes = {"xc": (B, S, Di), "dt": (B, S, Di), "Bc": (B, S, N),
              "Cc": (B, S, N), "A": (Di, N)}
    for name, t in (("xc", xc), ("dt", dt), ("Bc", Bc), ("Cc", Cc),
                    ("A", A)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        want = torch.float32 if name == "A" else xc.dtype
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N > MAX_STATE:
        raise ValueError(f"state size {N} exceeds the kernel's {MAX_STATE}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid (65535)")
    y = torch.empty_like(xc)
    h_last = torch.zeros((B, Di, N), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, h_last
    lib = typed_library(SOURCE, _signatures)
    fn = (lib.selective_scan_f32 if xc.dtype == torch.float32
          else lib.selective_scan_bf16)
    with torch.cuda.device(dev):
        status = fn(xc.data_ptr(), dt.data_ptr(), Bc.data_ptr(),
                    Cc.data_ptr(), A.data_ptr(), y.data_ptr(),
                    h_last.data_ptr(), B, S, Di, N, current_stream())
    raise_on(status, "selective_scan")
    launches["selective_scan"] += 1
    return y, h_last
