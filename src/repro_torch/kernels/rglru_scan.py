"""Checked wrapper of the CUDA RG-LRU scan kernel (recurrentgemma-2b).

``rglru_scan`` replaces the Pallas ``rglru_scan`` of
``src/repro/kernels/rglru_scan.py`` (its ``_kernel``).  The kernel lives in
``csrc/rglru_scan.cu``; see the note there for what bounds it on an H100
and how its design answers it.

Given CPU tensors the wrapper computes the plain version from `ref`.  Given
CUDA tensors it launches the kernel on the current stream or raises: there
is no fallback.  Each launch adds one to ``launches["rglru_scan"]``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .launch import P, current_stream, launches, raise_on, typed_library
from .ref import rglru_scan_ref

SOURCE = "rglru_scan.cu"

_I = ctypes.c_int
_signatures = {name: [P, P, P, P, _I, _I, _I, P]
               for name in ("rglru_scan_f32", "rglru_scan_bf16")}


def rglru_scan(a: torch.Tensor, bx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + bx_t over (B, S, W), h_{-1} = 0 ->
    (hs (B, S, W) in a's type, h_last (B, W) float32).

    ``a`` and ``bx`` are float32 or bfloat16, of one type and shape; the
    state is carried in float32.
    """
    if a.device.type == "cpu":
        return rglru_scan_ref(a, bx)
    dev = a.device
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a must be float32 or bfloat16, got {a.dtype}")
    for name, t in (("a", a), ("bx", bx)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != a.dtype:
            raise TypeError(f"{name} must be {a.dtype} like a, got {t.dtype}")
        if t.dim() != 3 or t.shape != a.shape:
            raise ValueError(f"a and bx must be one (B, S, W) shape, got "
                             f"{tuple(a.shape)} and {tuple(bx.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, S, W = a.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid (65535)")
    hs = torch.empty_like(a)
    if hs.numel() == 0:
        return hs, torch.zeros((B, W), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, W), dtype=torch.float32, device=dev)
    lib = typed_library(SOURCE, _signatures)
    fn = (lib.rglru_scan_f32 if a.dtype == torch.float32
          else lib.rglru_scan_bf16)
    with torch.cuda.device(dev):
        status = fn(a.data_ptr(), bx.data_ptr(), hs.data_ptr(),
                    h_last.data_ptr(), B, S, W, current_stream())
    raise_on(status, "rglru_scan")
    launches["rglru_scan"] += 1
    return hs, h_last
