"""Checked wrappers of the CUDA flash-attention kernels, forward and
backward.

``flash_attention`` replaces the Pallas ``flash_attention`` of
``src/repro/kernels/flash_attention.py`` (its ``_kernel``).  The forward
kernel lives in ``csrc/flash_attention.cu``, the backward in
``csrc/flash_attention_bwd.cu`` (the JAX package has no backward kernel:
its training differentiates the jnp attention); see the notes there for
what bounds them on an H100 and how their designs answer it.

When autograd needs a gradient (grad enabled and an input requires it),
`flash_attention` is a `torch.autograd.Function`: its forward also writes
each query row's log-sum-exp, saves q, k, v, the output and the lse, and
its backward is `flash_attention_bwd`.  Otherwise (serving) it is the plain
forward call with no lse.

Given CPU tensors the wrappers compute the plain versions from `ref`
(`flash_attention_lse_ref`, `flash_attention_bwd_ref`).  Given meta
tensors (a plan traced with nothing allocated, `repro_torch.launch.dryrun`)
they return meta outputs of the kernels' shapes and types and build and
launch nothing.  Given CUDA tensors they launch the kernels on the current
stream or raise: there is no fallback.  Each forward launch adds one to
``launches["flash_attention"]``, each backward (the row sums of dO o, then
dK and dV, then their sums over a group's query heads when heads share a
K/V head, then dQ) one to ``launches["flash_attention_bwd"]`` (a bfloat16 launch of the forward
with lse, or of the backward, one to ``bf16_launches`` too).  Both
directions take float32 or bfloat16 (training at the plans' bfloat16: the
backward's gradients in the inputs' type).  Every call reports its
kernel's work (`forward_cost`, `backward_cost`: the reachable pairs of the
causal or windowed mask, not a dense score matrix) to an active op
counter (`launch.kernel_work`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .launch import (P, bf16_launches, current_stream, kernel_work,
                     launches, raise_on, typed_library)
from .ref import (flash_attention_bwd_ref, flash_attention_lse_ref,
                  flash_attention_ref)

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
MAX_DIM = 256                   # largest head dim the kernels take

_I, _F = ctypes.c_int, ctypes.c_float
_signatures = {name: [P, P, P, P, _I, _I, _I, _I, _I, _I, _F, _I, _F, P]
               for name in ("fa_forward_f32", "fa_forward_bf16")}
_signatures.update({name: [P, P, P, P, P, _I, _I, _I, _I, _I, _I, _F, _I,
                            _F, P]
                    for name in ("fa_forward_lse_f32", "fa_forward_lse_bf16")})
_bwd_signatures = {name: [P] * 10 + [_I] * 6 + [_F, _I, _F, P]
                   for name in ("fa_backward_f32", "fa_backward_bf16")}


def reachable_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs of one (b, h) that the causal mask, and the
    window when ``window > 0``, keeps: the pairs the kernels compute."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def forward_cost(B, S, H, Kv, d, dv, window=0, itemsize=4,
                 lse=False) -> Tuple[int, int]:
    """(operations, bytes) of one forward launch: two products over the
    reachable pairs, 2 (d + dv) operations each; q, k, v read once and the
    output (and the float32 lse) written once."""
    flops = B * H * reachable_pairs(S, window) * 2 * (d + dv)
    n_bytes = itemsize * B * S * (H * d + Kv * (d + dv) + H * dv)
    return flops, n_bytes + (4 * B * H * S if lse else 0)


def backward_cost(B, S, H, Kv, d, dv, window=0,
                  itemsize=4) -> Tuple[int, int]:
    """(operations, bytes) of one backward launch: five products over the
    reachable pairs (S, dP, dV, dK, dQ), 2 (3 d + 2 dv) operations each;
    q, k, v, o, dO and the lse read once, dq, dk, dv written once."""
    flops = B * H * reachable_pairs(S, window) * 2 * (3 * d + 2 * dv)
    n_bytes = itemsize * 2 * B * S * (H * d + Kv * (d + dv) + H * dv)
    return flops, n_bytes + 4 * B * H * S


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


def _check_qkv(q, k, v):
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


def _forward(q, k, v, window: int, softcap: float, with_lse: bool
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (out, lse (B, H, S) float32 or None)."""
    B, S, H, d = q.shape
    flops, n_bytes = forward_cost(B, S, H, k.shape[2], d, v.shape[3],
                                  max(int(window), 0), q.element_size(),
                                  with_lse)
    with kernel_work("flash_attention", flops, n_bytes):
        return _forward_call(q, k, v, window, softcap, with_lse)


def _forward_call(q, k, v, window, softcap, with_lse):
    if q.device.type == "meta":
        _check_qkv(q, k, v)
        B, S, H, _ = q.shape
        out = q.new_empty((B, S, H, v.shape[3]))
        return out, (q.new_empty((B, H, S), dtype=torch.float32)
                     if with_lse else None)
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_lse_ref(q, k, v, window=window,
                                           softcap=softcap)
        return flash_attention_ref(q, k, v, window=window,
                                   softcap=softcap), None
    _check_qkv(q, k, v)
    dev = q.device
    B, S, H, d = q.shape
    Kv, dv = k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    lib = typed_library(SOURCE, _signatures)
    args = (B, S, H, Kv, d, dv, d ** -0.5, max(int(window), 0),
            float(softcap), current_stream())
    with torch.cuda.device(dev):
        if with_lse:
            fn = (lib.fa_forward_lse_f32 if q.dtype == torch.float32
                  else lib.fa_forward_lse_bf16)
            status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), *args)
        else:
            fn = (lib.fa_forward_f32 if q.dtype == torch.float32
                  else lib.fa_forward_bf16)
            status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), *args)
    raise_on(status, "flash_attention")
    launches["flash_attention"] += 1
    if with_lse and q.dtype == torch.bfloat16:
        bf16_launches["flash_attention"] += 1
    return out, lse


def bwd_scratch_floats(B: int, S: int, H: int, Kv: int, d: int,
                       dv: int) -> int:
    """Floats of the backward's scratch: the row sums D (B, H, S) and, when
    query heads share a K/V head, each head's partial dK (B, H, S, d) and
    dV (B, H, S, dv), each region from a multiple of 64 floats (the C
    interface's rule)."""
    n = B * H * S
    if H == Kv:
        return n
    up = lambda x: -(-x // 64) * 64
    return up(n) + up(n * d) + n * dv


def flash_attention_bwd(q, k, v, out, lse, dout, *, window: int = 0,
                        softcap: float = 0.0):
    """The gradient of `flash_attention` at (q, k, v) given its output, its
    lse (B, H, S) float32 and d out -> (dq, dk, dv) in q's type (float32
    or bfloat16; out and dout in it too)."""
    B, S, H, d = q.shape
    flops, n_bytes = backward_cost(B, S, H, k.shape[2], d, v.shape[3],
                                   max(int(window), 0), q.element_size())
    with kernel_work("flash_attention_bwd", flops, n_bytes):
        return _backward_call(q, k, v, out, lse, dout, window, softcap)


def _backward_call(q, k, v, out, lse, dout, window, softcap):
    if q.device.type == "meta":
        _check_qkv(q, k, v)
        return tuple(torch.empty_like(t) for t in (q, k, v))
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       window=window, softcap=softcap)
    _check_qkv(q, k, v)
    dev = q.device
    B, S, H, d = q.shape
    Kv, dv = k.shape[2], v.shape[3]
    for name, t in (("out", out), ("dout", dout)):
        _check(name, t, dev, q.dtype)
        if t.shape != (B, S, H, dv):
            raise ValueError(f"{name} must be {(B, S, H, dv)}, got "
                             f"{tuple(t.shape)}")
    _check("lse", lse, dev, torch.float32, ndim=3)
    if lse.shape != (B, H, S):
        raise ValueError(f"lse must be {(B, H, S)}, got {tuple(lse.shape)}")
    dq, dk, dvv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dvv.zero_()
    scratch = torch.empty((bwd_scratch_floats(B, S, H, Kv, d, dv),),
                          dtype=torch.float32, device=dev)
    lib = typed_library(BWD_SOURCE, _bwd_signatures)
    fn = (lib.fa_backward_f32 if q.dtype == torch.float32
          else lib.fa_backward_bf16)
    with torch.cuda.device(dev):
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), B, S, H, Kv, d,
            dv, d ** -0.5, max(int(window), 0), float(softcap),
            current_stream())
    raise_on(status, "flash_attention_bwd")
    launches["flash_attention_bwd"] += 1
    if q.dtype == torch.bfloat16:
        bf16_launches["flash_attention_bwd"] += 1
    return dq, dk, dvv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its lse, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, softcap: float):
        out, lse = _forward(q, k, v, window, softcap, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.softcap = window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         window=ctx.window,
                                         softcap=ctx.softcap)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Causal softmax attention, (B,S,H,d) x (B,S,Kv,d) x (B,S,Kv,dv) ->
    (B,S,H,dv), query head h reading K/V head h // (H / Kv).

    ``window > 0`` keeps keys j with i - window < j <= i; ``softcap > 0``
    caps the scaled scores at softcap * tanh(s / softcap).  float32 or
    bfloat16 (one type for all three); accumulates in float32 and returns
    q's type.  d and dv are at most 256.  Differentiable (either type)
    when an input requires a gradient.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, int(window), float(softcap))
    return _forward(q, k, v, window, softcap, with_lse=False)[0]
