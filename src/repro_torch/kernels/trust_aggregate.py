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

A population of P federations (`repro_torch.pop`) runs its rounds under
``torch.func.vmap``.  Both public functions are custom operators
(``torch.library.custom_op``) whose batching rules call the
population-batched wrappers `trust_aggregate_pop` and
`trust_aggregate_global_pop`: one launch for all P members, over one more
grid axis (counted as ``trust_aggregate_pop``,
``trust_aggregate_dense_pop`` and ``trust_aggregate_global_pop``).  Slice
p of a batched launch is bitwise the single kernel's result on member p's
tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .launch import P, current_stream, launches, raise_on, typed_library
from .ref import (trust_aggregate_global_pop_ref,
                  trust_aggregate_global_ref, trust_aggregate_pop_ref,
                  trust_aggregate_ref)

SOURCE = "trust_aggregate.cu"

_signatures = {
    "ta_aggregate_f32": [P, P, P, P, ctypes.c_int, ctypes.c_longlong, P],
    "ta_aggregate_bf16": [P, P, P, P, ctypes.c_int, ctypes.c_longlong, P],
    "ta_aggregate_global_f32": [P, P, P, P, P, P, P, ctypes.c_int,
                                ctypes.c_int, ctypes.c_longlong, P],
    "ta_aggregate_pop_f32": [P, P, P, P, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong, P],
    "ta_aggregate_pop_bf16": [P, P, P, P, ctypes.c_int, ctypes.c_int,
                              ctypes.c_longlong, P],
    "ta_aggregate_global_pop_f32": [P, P, P, P, P, P, P, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_longlong, P],
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


def _aggregate(params_flat: torch.Tensor, weights: torch.Tensor,
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


def _aggregate_global(updates_flat: torch.Tensor, weights: torch.Tensor,
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


# --------------------------------------------------------------------- #
# population-batched launches: P federations, one more grid axis
# --------------------------------------------------------------------- #
def _check_batch(name, t, shape, device, dtypes=(torch.float32,)):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def trust_aggregate_pop(params_flat: torch.Tensor, weights: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`trust_aggregate` of P federations in one launch: (P, C, N) x
    (P, C) [x (P, C) mask] -> (P, N).  Slice p equals `trust_aggregate` of
    member p's tensors bit for bit."""
    if params_flat.device.type == "cpu":
        return trust_aggregate_pop_ref(params_flat, weights, mask)
    dev = params_flat.device
    if params_flat.dim() != 3 or params_flat.shape[1] < 1:
        raise ValueError("params_flat must be (P, rows >= 1, N), got "
                         f"{tuple(params_flat.shape)}")
    pop, C, N = params_flat.shape
    _check_batch("params_flat", params_flat, (pop, C, N), dev,
                 (torch.float32, torch.bfloat16))
    _check_batch("weights", weights, (pop, C), dev)
    if mask is not None:
        _check_batch("mask", mask, (pop, C), dev)
    out = torch.empty((pop, N), dtype=params_flat.dtype, device=dev)
    if N == 0 or pop == 0:
        return out
    fn = (_lib().ta_aggregate_pop_f32 if params_flat.dtype == torch.float32
          else _lib().ta_aggregate_pop_bf16)
    with torch.cuda.device(dev):
        status = fn(params_flat.data_ptr(), weights.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), pop, C, N, current_stream())
    raise_on(status, "trust_aggregate_pop")
    launches["trust_aggregate_pop" if mask is not None
             else "trust_aggregate_dense_pop"] += 1
    return out


def trust_aggregate_global_pop(updates_flat: torch.Tensor,
                               weights: torch.Tensor, mask: torch.Tensor,
                               stack_flat: torch.Tensor,
                               global_weights: torch.Tensor,
                               c: torch.Tensor) -> torch.Tensor:
    """`trust_aggregate_global` of P federations in one launch: (P, C, N)
    updates, (P, C) weights and mask, (P, B, N) stacks, (P, B) staleness
    weights and (P,) int32 rows ``c`` (each read on the card; ``c[p] ==
    B`` means no member row) -> (P, N).  Slice p equals
    `trust_aggregate_global` of member p's tensors bit for bit: each slice
    runs the single kernel's launch plan at (C, B, N)."""
    if updates_flat.device.type == "cpu":
        return trust_aggregate_global_pop_ref(updates_flat, weights, mask,
                                              stack_flat, global_weights, c)
    dev = updates_flat.device
    if updates_flat.dim() != 3 or updates_flat.shape[1] < 1:
        raise ValueError("updates_flat must be (P, rows >= 1, N), got "
                         f"{tuple(updates_flat.shape)}")
    pop, C, N = updates_flat.shape
    if stack_flat.dim() != 3 or stack_flat.shape[1] < 1:
        raise ValueError("stack_flat must be (P, clusters >= 1, N), got "
                         f"{tuple(stack_flat.shape)}")
    B = stack_flat.shape[1]
    _check_batch("updates_flat", updates_flat, (pop, C, N), dev)
    _check_batch("stack_flat", stack_flat, (pop, B, N), dev)
    _check_batch("weights", weights, (pop, C), dev)
    _check_batch("mask", mask, (pop, C), dev)
    _check_batch("global_weights", global_weights, (pop, B), dev)
    _check_batch("c", c, (pop,), dev, (torch.int32,))
    out = torch.empty((pop, N), dtype=torch.float32, device=dev)
    if N == 0 or pop == 0:
        return out
    with torch.cuda.device(dev):
        status = _lib().ta_aggregate_global_pop_f32(
            updates_flat.data_ptr(), weights.data_ptr(), mask.data_ptr(),
            stack_flat.data_ptr(), global_weights.data_ptr(), c.data_ptr(),
            out.data_ptr(), pop, C, B, N, current_stream())
    raise_on(status, "trust_aggregate_global_pop")
    launches["trust_aggregate_global_pop"] += 1
    return out


# --------------------------------------------------------------------- #
# the public functions: custom operators whose batching rule (under
# torch.func.vmap) launches the population-batched kernel once
# --------------------------------------------------------------------- #
def _batch_first(x, bdim, size):
    """``x`` with its batch dim first and contiguous (an unbatched ``x``
    repeated ``size`` times)."""
    if bdim is None:
        return x.expand((size,) + tuple(x.shape)).contiguous()
    return x.movedim(bdim, 0).contiguous()


@torch.library.custom_op("repro_torch::trust_aggregate", mutates_args=())
def _aggregate_op(params_flat: torch.Tensor, weights: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    return _aggregate(params_flat, weights, mask)


@_aggregate_op.register_fake
def _aggregate_fake(params_flat, weights, mask):
    # shape and dtype only, for tracers on fake tensors (torch.compile,
    # make_fx, torch.export); it computes nothing
    return params_flat.new_empty(params_flat.shape[1:])


@_aggregate_op.register_vmap
def _aggregate_vmap(info, in_dims, params_flat, weights, mask):
    size = info.batch_size
    x = _batch_first(params_flat, in_dims[0], size)
    w = _batch_first(weights, in_dims[1], size)
    m = None if mask is None else _batch_first(mask, in_dims[2], size)
    return trust_aggregate_pop(x, w, m), 0


@torch.library.custom_op("repro_torch::trust_aggregate_global",
                         mutates_args=())
def _aggregate_global_op(updates_flat: torch.Tensor, weights: torch.Tensor,
                         mask: torch.Tensor, stack_flat: torch.Tensor,
                         global_weights: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    return _aggregate_global(updates_flat, weights, mask, stack_flat,
                             global_weights, c)


@_aggregate_global_op.register_fake
def _aggregate_global_fake(updates_flat, weights, mask, stack_flat,
                           global_weights, c):
    return updates_flat.new_empty(updates_flat.shape[1:],
                                  dtype=torch.float32)


@_aggregate_global_op.register_vmap
def _aggregate_global_vmap(info, in_dims, *args):
    size = info.batch_size
    x, w, m, stack, gw, c = (_batch_first(a, d, size)
                             for a, d in zip(args, in_dims))
    return trust_aggregate_global_pop(x, w, m, stack, gw,
                                      c.reshape(size)), 0


# DTensor sharding rules: under the partitioner-inferred placement
# (`repro_torch.api.placement`, ``impl='gspmd'``) each operator takes its
# inputs replicated and launches its kernel on every rank's local tensors,
# whose result is the replicated output.  (Eqns 6 and 19 sum over rows, so
# a column-sharded strategy would be exact too; no round produces such
# inputs.)  Registered on first use of that placement, so that importing
# this module does not load DTensor.
_dtensor_rules = []


def register_dtensor_rules() -> None:
    """Register the operators' DTensor sharding rules (once)."""
    if _dtensor_rules:
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.trust_aggregate.default)
    def _aggregate_sharding(params_flat, weights, mask):
        return [([Replicate()], [Replicate(), Replicate(),
                                 None if mask is None else Replicate()])]

    @register_sharding(torch.ops.repro_torch.trust_aggregate_global.default)
    def _aggregate_global_sharding(*args):
        return [([Replicate()], [Replicate()] * len(args))]

    _dtensor_rules.extend([_aggregate_sharding, _aggregate_global_sharding])


def trust_aggregate(params_flat: torch.Tensor, weights: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, N) x (C,) -> (N,): sum over c of w_c * m_c * x[c, :].

    ``params_flat`` is float32 or bfloat16; ``weights`` and ``mask`` are
    (C,) float32 (``mask`` None: every row counts).  Accumulates in float32
    and returns the input dtype.  Rows with mask 0 contribute exactly zero.
    Under ``torch.func.vmap`` it is one `trust_aggregate_pop` launch.
    """
    return _aggregate_op(params_flat, weights, mask)


def trust_aggregate_global(updates_flat: torch.Tensor, weights: torch.Tensor,
                           mask: torch.Tensor, stack_flat: torch.Tensor,
                           global_weights: torch.Tensor,
                           c: torch.Tensor) -> torch.Tensor:
    """Fused Eqn 6 + Eqn 19: (C, N) member updates -> the (N,) global model.

    The masked Eqn-6 aggregate replaces row ``c`` of the (B, N) cluster
    stack before the (B,) staleness-weighted sum.  All tensors are float32;
    ``c`` is an int32 scalar tensor on the same device (read by the kernel,
    never by the host).  Under ``torch.func.vmap`` it is one
    `trust_aggregate_global_pop` launch.
    """
    return _aggregate_global_op(updates_flat, weights, mask, stack_flat,
                                global_weights, c)
