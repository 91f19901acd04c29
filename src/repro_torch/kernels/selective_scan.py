"""Checked wrappers of the CUDA Mamba-1 selective-scan kernels
(falcon-mamba-7b), forward and backward.

``selective_scan`` replaces the Pallas ``selective_scan`` of
``src/repro/kernels/selective_scan.py`` (its ``_kernel``).  The forward
kernel lives in ``csrc/selective_scan.cu``, the backward in
``csrc/selective_scan_bwd.cu`` (the JAX package has no backward kernel:
its training differentiates the ``lax.scan`` of ``mamba_forward``); see the
notes there for what bounds them on an H100 and how their designs answer
it.

When autograd needs a gradient (grad enabled and an input requires it),
`selective_scan` is a `torch.autograd.Function` that saves its five inputs
and whose backward is `selective_scan_bwd` (which recomputes the states).

Given CPU tensors the wrappers compute the plain versions from `ref`.
Given CUDA tensors they launch the kernels on the current stream or raise:
there is no fallback.  Each forward launch adds one to
``launches["selective_scan"]``, each backward (the scan, then the sums of
its partials) one to ``launches["selective_scan_bwd"]``.  The backward
takes float32 only; a bfloat16 input that needs a gradient raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .launch import P, current_stream, launches, raise_on, typed_library
from .ref import selective_scan_bwd_ref, selective_scan_ref

SOURCE = "selective_scan.cu"
BWD_SOURCE = "selective_scan_bwd.cu"
MAX_STATE = 64                  # largest N the kernels take
BWD_CHUNK = 32                  # the backward's steps a chunk (the .cu's)
BWD_THREADS = 64                # and its threads a block

_I = ctypes.c_int
_signatures = {name: [P, P, P, P, P, P, P, _I, _I, _I, _I, P]
               for name in ("selective_scan_f32", "selective_scan_bf16")}
_bwd_signatures = {"selective_scan_bwd_f32": [P] * 13 + [_I] * 4 + [P]}


def _check(xc, dt, Bc, Cc, A, dtypes, extra=()):
    """xc, dt (B,S,Di), Bc, Cc (B,S,N) of one type in ``dtypes``, A (Di,N)
    float32, and ``extra`` (name, tensor, shape) float32, all contiguous
    on xc's device."""
    dev = xc.device
    if xc.dtype not in dtypes:
        raise TypeError(f"xc must be one of {dtypes}, got {xc.dtype}")
    if xc.dim() != 3 or Bc.dim() != 3 or A.dim() != 2:
        raise ValueError(f"expected xc (B,S,Di), Bc (B,S,N) and A (Di,N), "
                         f"got {tuple(xc.shape)}, {tuple(Bc.shape)} and "
                         f"{tuple(A.shape)}")
    B, S, Di = xc.shape
    N = A.shape[1]
    todo = [("xc", xc, (B, S, Di), xc.dtype), ("dt", dt, (B, S, Di), xc.dtype),
            ("Bc", Bc, (B, S, N), xc.dtype), ("Cc", Cc, (B, S, N), xc.dtype),
            ("A", A, (Di, N), torch.float32)]
    todo += [(name, t, shape, torch.float32) for name, t, shape in extra]
    for name, t, shape, want in todo:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N > MAX_STATE:
        raise ValueError(f"state size {N} exceeds the kernel's {MAX_STATE}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid (65535)")


def _forward(xc, dt, Bc, Cc, A) -> Tuple[torch.Tensor, torch.Tensor]:
    if xc.device.type == "cpu":
        return selective_scan_ref(xc, dt, Bc, Cc, A)
    _check(xc, dt, Bc, Cc, A, (torch.float32, torch.bfloat16))
    dev = xc.device
    B, S, Di = xc.shape
    N = A.shape[1]
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


def bwd_scratch_floats(B: int, S: int, Di: int, N: int) -> int:
    """Floats of the backward's scratch: the states entering each chunk of
    32 steps (chunks, B, N, Di), each block's partial sums of dBc and dCc
    (blocks, B, S, 2, N) and each b's dA (B, N, Di), each region from a
    multiple of 64 floats (the C interface's rule); a block holds 64 / L
    channels, L = 1, 2 or 4 lanes a channel for N <= 16, 32 or 64."""
    lanes = 1
    while lanes * 16 < N:
        lanes *= 2
    blocks = -(-Di // (BWD_THREADS // lanes))
    up = lambda x: -(-x // 64) * 64
    return (up(-(-S // BWD_CHUNK) * B * Di * N) + up(blocks * B * S * 2 * N)
            + B * N * Di)


def selective_scan_bwd(xc, dt, Bc, Cc, A, dy, dh_last=None):
    """The gradient of `selective_scan` at (xc, dt, Bc, Cc, A) given dy
    (B, S, Di) and d h_last (B, Di, N), or None when no gradient reaches
    the final state -> (dxc, ddt, dBc, dCc, dA), float32 only."""
    if xc.device.type == "cpu":
        return selective_scan_bwd_ref(xc, dt, Bc, Cc, A, dy, dh_last)
    B, S, Di = xc.shape
    N = A.shape[1]
    extra = [("dy", dy, (B, S, Di))]
    if dh_last is not None:
        extra.append(("dh_last", dh_last, (B, Di, N)))
    _check(xc, dt, Bc, Cc, A, (torch.float32,), extra)
    dxc, ddt, dBc, dCc = (torch.empty_like(t) for t in (xc, dt, Bc, Cc))
    dA = torch.empty_like(A)
    if xc.numel() == 0:
        return dxc, ddt, dBc.zero_(), dCc.zero_(), dA.zero_()
    scratch = torch.empty((bwd_scratch_floats(B, S, Di, N),),
                          dtype=torch.float32, device=xc.device)
    lib = typed_library(BWD_SOURCE, _bwd_signatures)
    with torch.cuda.device(xc.device):
        status = lib.selective_scan_bwd_f32(
            xc.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(),
            dxc.data_ptr(), ddt.data_ptr(), dBc.data_ptr(), dCc.data_ptr(),
            dA.data_ptr(), scratch.data_ptr(), B, S, Di, N, current_stream())
    raise_on(status, "selective_scan_bwd")
    launches["selective_scan_bwd"] += 1
    return dxc, ddt, dBc, dCc, dA


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel, saving its inputs, and the backward kernel."""

    @staticmethod
    def forward(ctx, xc, dt, Bc, Cc, A):
        if xc.device.type != "cpu" and xc.dtype != torch.float32:
            raise TypeError(f"the selective-scan backward takes float32 "
                            f"only, got {xc.dtype}")
        y, h_last = _forward(xc, dt, Bc, Cc, A)
        ctx.save_for_backward(xc, dt, Bc, Cc, A)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        saved = ctx.saved_tensors          # unpacked once (the checkpoint)
        dy = torch.zeros_like(saved[0]) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        return selective_scan_bwd(*saved, dy, dh_last)


def selective_scan(xc: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 recurrence h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,
    y_t = h_t C_t, h_{-1} = 0.  xc, dt: (B,S,Di); Bc, Cc: (B,S,N);
    A: (Di,N) float32 -> (y (B,S,Di) in xc's type, h_last (B,Di,N) f32).

    xc, dt, Bc and Cc are float32 or bfloat16, all one type; the state is
    carried in float32.  N is at most 64.  Differentiable (float32) when an
    input requires a gradient.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, dt, Bc, Cc, A)):
        return _SelectiveScan.apply(xc, dt, Bc, Cc, A)
    return _forward(xc, dt, Bc, Cc, A)
