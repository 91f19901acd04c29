"""Checked wrappers of the CUDA trust-aggregation kernels (paper Eqns 6, 19).

``trust_aggregate`` replaces the Pallas ``trust_aggregate`` of
``src/repro/kernels/trust_aggregate.py`` (its dense ``_kernel`` and masked
``_masked_kernel``), ``trust_aggregate_global`` its fused ``_global_kernel``.
The kernels live in ``csrc/trust_aggregate.cu``; see the note there for
what bounds them on an H100 and how their design answers it.

A wrapper given CPU tensors computes the plain version from `ref`.  Given
CUDA tensors it launches its kernel on the current stream or raises: there
is no fallback.  Each launch adds one to its count in `launch.launches`
(``trust_aggregate`` with a mask, ``trust_aggregate_dense`` without one,
``trust_aggregate_global``), so a run can show that its rounds went through
the kernels.  `global_plan` reports how the fused kernel is launched at a
shape.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .launch import P, current_stream, launches, raise_on, typed_library
from .ref import trust_aggregate_global_ref, trust_aggregate_ref

SOURCE = "trust_aggregate.cu"

_signatures = {
    "ta_aggregate_f32": [P, P, P, P, ctypes.c_int, ctypes.c_longlong, P],
    "ta_aggregate_bf16": [P, P, P, P, ctypes.c_int, ctypes.c_longlong, P],
    "ta_aggregate_global_f32": [P, P, P, P, P, P, P, ctypes.c_int,
                                ctypes.c_int, ctypes.c_longlong, P],
}


def _lib() -> ctypes.CDLL:
    return typed_library(SOURCE, _signatures)


def global_plan(rows: int, clusters: int, n: int) -> dict:
    """How ``trust_aggregate_global`` launches at (C, B, N) on the current
    card: threads a block, blocks a cluster (``split``; 1 is a launch
    without a cluster), columns a tile, column tiles, blocks in the grid,
    rows a thread loads at once, and the clusters the card holds at once
    (0 without a cluster).  Needs the card."""
    fn = _lib().ta_global_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_int * 7)()
    raise_on(fn(rows, clusters, n, plan), "ta_global_plan")
    keys = ("threads", "split", "tile_columns", "tiles", "grid",
            "rows_in_flight", "max_active_clusters")
    return {**dict(zip(keys, plan)), "cluster_launch": plan[1] > 1}


def _check_vector(name, t, length, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.shape != (length,):
        raise ValueError(f"{name} must have shape ({length},), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_matrix(name, t, device, dtypes):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] < 1:
        raise ValueError(f"{name} must be (rows >= 1, N), got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def trust_aggregate(params_flat: torch.Tensor, weights: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, N) x (C,) -> (N,): sum over c of w_c * m_c * x[c, :].

    ``params_flat`` is float32 or bfloat16; ``weights`` and ``mask`` are
    (C,) float32 (``mask`` None: every row counts).  Accumulates in float32
    and returns the input dtype.  Rows with mask 0 contribute exactly zero.
    """
    if params_flat.device.type == "cpu":
        return trust_aggregate_ref(params_flat, weights, mask)
    dev = params_flat.device
    _check_matrix("params_flat", params_flat, dev,
                  (torch.float32, torch.bfloat16))
    C, N = params_flat.shape
    _check_vector("weights", weights, C, dev)
    if mask is not None:
        _check_vector("mask", mask, C, dev)
    out = torch.empty((N,), dtype=params_flat.dtype, device=dev)
    if N == 0:
        return out
    fn = (_lib().ta_aggregate_f32 if params_flat.dtype == torch.float32
          else _lib().ta_aggregate_bf16)
    with torch.cuda.device(dev):
        status = fn(params_flat.data_ptr(), weights.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), C, N, current_stream())
    raise_on(status, "trust_aggregate")
    launches["trust_aggregate" if mask is not None
             else "trust_aggregate_dense"] += 1
    return out


def trust_aggregate_global(updates_flat: torch.Tensor, weights: torch.Tensor,
                           mask: torch.Tensor, stack_flat: torch.Tensor,
                           global_weights: torch.Tensor,
                           c: torch.Tensor) -> torch.Tensor:
    """Fused Eqn 6 + Eqn 19: (C, N) member updates -> the (N,) global model.

    The masked Eqn-6 aggregate replaces row ``c`` of the (B, N) cluster
    stack before the (B,) staleness-weighted sum.  All tensors are float32;
    ``c`` is an int32 scalar tensor on the same device (read by the kernel,
    never by the host).
    """
    if updates_flat.device.type == "cpu":
        return trust_aggregate_global_ref(updates_flat, weights, mask,
                                          stack_flat, global_weights, c)
    dev = updates_flat.device
    _check_matrix("updates_flat", updates_flat, dev, (torch.float32,))
    _check_matrix("stack_flat", stack_flat, dev, (torch.float32,))
    C, N = updates_flat.shape
    B = stack_flat.shape[0]
    if stack_flat.shape[1] != N:
        raise ValueError(f"stack_flat has {stack_flat.shape[1]} columns, "
                         f"updates_flat {N}")
    _check_vector("weights", weights, C, dev)
    _check_vector("mask", mask, C, dev)
    _check_vector("global_weights", global_weights, B, dev)
    if c.device != dev or c.dtype != torch.int32 or c.numel() != 1:
        raise ValueError("c must be one int32 element on "
                         f"{dev}, got {c.dtype} {tuple(c.shape)} on "
                         f"{c.device}")
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    with torch.cuda.device(dev):
        status = _lib().ta_aggregate_global_f32(
            updates_flat.data_ptr(), weights.data_ptr(), mask.data_ptr(),
            stack_flat.data_ptr(), global_weights.data_ptr(), c.data_ptr(),
            out.data_ptr(), C, B, N, current_stream())
    raise_on(status, "trust_aggregate_global")
    launches["trust_aggregate_global"] += 1
    return out
