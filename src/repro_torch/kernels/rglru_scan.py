"""Checked wrappers of the CUDA RG-LRU scan kernels (recurrentgemma-2b),
forward and backward.

``rglru_scan`` replaces the Pallas ``rglru_scan`` of
``src/repro/kernels/rglru_scan.py`` (its ``_kernel``).  The forward kernel
lives in ``csrc/rglru_scan.cu``, the backward in ``csrc/rglru_scan_bwd.cu``
(the JAX package has no backward kernel: its training differentiates the
``lax.scan`` of ``rglru_forward``); see the notes there for what bounds
them on an H100 and how their designs answer it.

When autograd needs a gradient (grad enabled and an input requires it),
`rglru_scan` is a `torch.autograd.Function` that saves a and hs, and whose
backward is `rglru_scan_bwd`.

Given CPU tensors the wrappers compute the plain versions from `ref`.
Given meta tensors they return meta outputs of the kernels' shapes and
types and build and launch nothing.  Given CUDA tensors they launch the
kernels on the current stream or raise: there is no fallback.  Each
forward launch adds one to ``launches["rglru_scan"]``, each backward
launch one to ``launches["rglru_scan_bwd"]`` (and a bfloat16 one to
``bf16_launches`` too).  Both take float32 or
bfloat16 (the backward's gradients in a's type; both packages'
recurrentgemma-2b scans float32 gates at any parameter type).  Every call
reports its kernel's work (`forward_cost`, `backward_cost`) to an active
op counter (`launch.kernel_work`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .launch import (P, bf16_launches, current_stream, kernel_work,
                     launches, raise_on, typed_library)
from .ref import rglru_scan_bwd_ref, rglru_scan_ref

SOURCE = "rglru_scan.cu"
BWD_SOURCE = "rglru_scan_bwd.cu"

_I = ctypes.c_int
_signatures = {name: [P, P, P, P, _I, _I, _I, P]
               for name in ("rglru_scan_f32", "rglru_scan_bf16")}
_bwd_signatures = {name: [P] * 6 + [_I, _I, _I, P]
                   for name in ("rglru_scan_bwd_f32", "rglru_scan_bwd_bf16")}


def forward_cost(B, S, W, itemsize=4) -> Tuple[int, int]:
    """(operations, bytes) of one forward launch: a multiply-add a step and
    channel; a and bx read, hs written once, h_last (float32) written."""
    return 2 * B * S * W, 3 * itemsize * B * S * W + 4 * B * W


def backward_cost(B, S, W, itemsize=4) -> Tuple[int, int]:
    """(operations, bytes) of one backward launch: two multiply-adds a step
    and channel (g, then d a); a, hs, d hs and d h_last read, d a and d bx
    written once."""
    return 4 * B * S * W, 5 * itemsize * B * S * W + 4 * B * W


def _check(names, tensors, dtypes):
    a = tensors[0]
    for name, t in zip(names, tensors):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, expected {a.device}")
        if t.dtype not in dtypes or t.dtype != a.dtype:
            raise TypeError(f"{name} must be one of {dtypes} like "
                            f"{names[0]}, got {t.dtype}")
        if t.dim() != 3 or t.shape != a.shape:
            raise ValueError(f"{', '.join(names)} must be one (B, S, W) "
                             f"shape, got {tuple(a.shape)} and "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.shape[0] > 65535:
        raise ValueError(f"batch {a.shape[0]} exceeds the grid (65535)")


def _forward(a: torch.Tensor, bx: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    flops, n_bytes = forward_cost(*a.shape, a.element_size())
    with kernel_work("rglru_scan", flops, n_bytes):
        return _forward_call(a, bx)


def _forward_call(a, bx):
    if a.device.type == "meta":
        _check(("a", "bx"), (a, bx), (torch.float32, torch.bfloat16))
        return torch.empty_like(a), a.new_empty(
            (a.shape[0], a.shape[2]), dtype=torch.float32)
    if a.device.type == "cpu":
        return rglru_scan_ref(a, bx)
    _check(("a", "bx"), (a, bx), (torch.float32, torch.bfloat16))
    dev = a.device
    B, S, W = a.shape
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


def rglru_scan_bwd(a: torch.Tensor, hs: torch.Tensor, dhs: torch.Tensor,
                   dh_last: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of `rglru_scan` at a, given its output hs, d hs
    (B, S, W) and d h_last (B, W) float32 -> (da, dbx) in a's type
    (float32 or bfloat16; hs and dhs in it too)."""
    flops, n_bytes = backward_cost(*a.shape, a.element_size())
    with kernel_work("rglru_scan_bwd", flops, n_bytes):
        return _backward_call(a, hs, dhs, dh_last)


def _backward_call(a, hs, dhs, dh_last):
    if a.device.type == "meta":
        _check(("a", "hs", "dhs"), (a, hs, dhs),
               (torch.float32, torch.bfloat16))
        return torch.empty_like(a), torch.empty_like(a)
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, hs, dhs, dh_last)
    _check(("a", "hs", "dhs"), (a, hs, dhs), (torch.float32, torch.bfloat16))
    B, S, W = a.shape
    if (dh_last.device != a.device or dh_last.dtype != torch.float32
            or dh_last.shape != (B, W) or not dh_last.is_contiguous()):
        raise ValueError(f"dh_last must be a contiguous float32 {(B, W)} on "
                         f"{a.device}, got {dh_last.dtype} "
                         f"{tuple(dh_last.shape)} on {dh_last.device}")
    da, dbx = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, dbx
    lib = typed_library(BWD_SOURCE, _bwd_signatures)
    fn = (lib.rglru_scan_bwd_f32 if a.dtype == torch.float32
          else lib.rglru_scan_bwd_bf16)
    with torch.cuda.device(a.device):
        status = fn(
            a.data_ptr(), hs.data_ptr(), dhs.data_ptr(), dh_last.data_ptr(),
            da.data_ptr(), dbx.data_ptr(), B, S, W, current_stream())
    raise_on(status, "rglru_scan_bwd")
    launches["rglru_scan_bwd"] += 1
    if a.dtype == torch.bfloat16:
        bf16_launches["rglru_scan_bwd"] += 1
    return da, dbx


class _RGLRUScan(torch.autograd.Function):
    """The forward kernel, saving a and hs, and the backward kernel."""

    @staticmethod
    def forward(ctx, a, bx):
        hs, h_last = _forward(a, bx)
        ctx.save_for_backward(a, hs)
        return hs, h_last

    @staticmethod
    def backward(ctx, dhs, dh_last):
        a, hs = ctx.saved_tensors
        return rglru_scan_bwd(a, hs, dhs.contiguous(),
                              dh_last.contiguous())


def rglru_scan(a: torch.Tensor, bx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + bx_t over (B, S, W), h_{-1} = 0 ->
    (hs (B, S, W) in a's type, h_last (B, W) float32).

    ``a`` and ``bx`` are float32 or bfloat16, of one type and shape; the
    state is carried in float32.  Differentiable (either type) when an
    input requires a gradient.
    """
    if torch.is_grad_enabled() and (a.requires_grad or bx.requires_grad):
        return _RGLRUScan.apply(a, bx)
    return _forward(a, bx)
