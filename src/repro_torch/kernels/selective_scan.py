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
`selective_scan` is a `torch.autograd.Function` whose forward also writes
the state entering each 32-step chunk (``selective_scan_states_f32``) and
saves it with its five inputs, and whose backward is `selective_scan_bwd`
given those states.  Called without them, `selective_scan_bwd` first runs
the forward kernel for them.  Inside `without_chunk_states` (the first
pass of a checkpointed layer, whose saved tensors are dropped and
recomputed) the forward writes none and saves a placeholder of their
shape.

Given CPU tensors the wrappers compute the plain versions from `ref`.
Given meta tensors they return meta outputs of the kernels' shapes and
types and build and launch nothing.  Given CUDA tensors they launch the
kernels on the current stream or raise: there is no fallback.  Each
forward launch adds one to ``launches["selective_scan"]``, and one that
also writes the chunk states one to ``state_launches["selective_scan"]``
as well; each backward (the walk, then the sums of its partials) adds one
to ``launches["selective_scan_bwd"]`` (a bfloat16 launch of the states'
forward or of the backward one to ``bf16_launches`` too).  Both take
float32 or bfloat16
(the chunk states float32 either way; the backward's gradients in the
inputs' types, dA float32).  Every call reports its kernel's work
(`forward_cost`, `backward_cost`) to an active op counter
(`launch.kernel_work`).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Dict, Tuple

import torch

from .launch import (P, bf16_launches, current_stream, kernel_work,
                     launches, raise_on, typed_library)
from .ref import (selective_scan_bwd_ref, selective_scan_chunk_states_ref,
                  selective_scan_ref)

SOURCE = "selective_scan.cu"
BWD_SOURCE = "selective_scan_bwd.cu"
MAX_STATE = 64                  # largest N the kernels take
CHUNK = 32                      # the forward's steps a chunk (the .cu's)
BWD_STATES = 4                  # the backward's states a lane (the .cu's)

_I = ctypes.c_int
_signatures = {name: [P, P, P, P, P, P, P, _I, _I, _I, _I, P]
               for name in ("selective_scan_f32", "selective_scan_bf16")}
_signatures.update({name: [P] * 8 + [_I] * 4 + [P]
                    for name in ("selective_scan_states_f32",
                                 "selective_scan_states_bf16")})
_bwd_signatures = {name: [P] * 14 + [_I] * 4 + [P]
                   for name in ("selective_scan_bwd_states_f32",
                                "selective_scan_bwd_states_bf16")}
_bwd_signatures["selective_scan_bwd_warps_per_sm"] = [_I]


def forward_cost(B, S, Di, N, itemsize=4, states=False) -> Tuple[int, int]:
    """(operations, bytes) of one forward launch: 6 N + 1 a (b, t, d) (the
    decay's product and exponential, dt x B, the state's multiply-add, y's
    product and sum); xc, dt, Bc, Cc read and y written once, A read and
    h_last (and the float32 chunk states) written."""
    n_bytes = itemsize * (3 * B * S * Di + 2 * B * S * N) + \
        4 * (Di * N + B * Di * N)
    if states:
        n_bytes += 4 * -(-S // CHUNK) * B * N * Di
    return B * S * Di * (6 * N + 1), n_bytes


def backward_cost(B, S, Di, N, itemsize=4,
                  dh_last=False) -> Tuple[int, int]:
    """(operations, bytes) of one backward launch given the chunk states:
    ~19 a (b, t, d, n) (the states rebuilt, g's recurrence, the four
    gradient terms); xc, dt, dy, Bc, Cc, A and the chunk states (and
    d h_last) read, dxc, ddt, dBc, dCc and dA written once."""
    n_bytes = itemsize * (5 * B * S * Di + 4 * B * S * N) + \
        4 * (2 * Di * N + -(-S // CHUNK) * B * N * Di)
    if dh_last:
        n_bytes += 4 * B * Di * N
    return 19 * B * S * Di * N, n_bytes

# forward launches that also wrote the chunk states (each is counted in
# launches["selective_scan"] too); reset and read beside `launches`
state_launches: Dict[str, int] = {"selective_scan": 0}

_keep_states = contextvars.ContextVar("keep_chunk_states", default=True)


@contextlib.contextmanager
def without_chunk_states():
    """`selective_scan`'s forwards in this context write no chunk states:
    a checkpoint's first pass, whose saved tensors its recompute replaces
    (`repro_torch.models.transformer.remat_contexts`)."""
    token = _keep_states.set(False)
    try:
        yield
    finally:
        _keep_states.reset(token)


def _check(xc, dt, Bc, Cc, A, dtypes, extra=()):
    """xc, dt (B,S,Di), Bc, Cc (B,S,N) of one type in ``dtypes``, A (Di,N)
    float32, and ``extra`` (name, tensor, shape, dtype), all contiguous
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
    todo += list(extra)
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


def _forward(xc, dt, Bc, Cc, A, states: bool = False):
    """(y, h_last), and with ``states`` the state entering each chunk of
    `CHUNK` steps, (chunks, B, N, Di) float32."""
    B, S, Di = xc.shape
    flops, n_bytes = forward_cost(B, S, Di, A.shape[1], xc.element_size(),
                                  states)
    with kernel_work("selective_scan", flops, n_bytes):
        return _forward_call(xc, dt, Bc, Cc, A, states)


def _forward_call(xc, dt, Bc, Cc, A, states):
    if xc.device.type == "meta":
        _check(xc, dt, Bc, Cc, A, (torch.float32, torch.bfloat16))
        B, S, Di = xc.shape
        f32 = dict(dtype=torch.float32)
        out = (torch.empty_like(xc), xc.new_empty((B, Di, A.shape[1]), **f32))
        return out + (xc.new_empty((-(-S // CHUNK), B, A.shape[1], Di),
                                   **f32),) if states else out
    if xc.device.type == "cpu":
        out = selective_scan_ref(xc, dt, Bc, Cc, A)
        return out + (selective_scan_chunk_states_ref(xc, dt, Bc, Cc, A),
                      ) if states else out
    _check(xc, dt, Bc, Cc, A, (torch.float32, torch.bfloat16))
    dev = xc.device
    B, S, Di = xc.shape
    N = A.shape[1]
    y = torch.empty_like(xc)
    h_last = torch.zeros((B, Di, N), dtype=torch.float32, device=dev)
    chunk_h = (torch.empty((-(-S // CHUNK), B, N, Di), dtype=torch.float32,
                           device=dev) if states else None)
    if y.numel() == 0:
        return (y, h_last, chunk_h) if states else (y, h_last)
    lib = typed_library(SOURCE, _signatures)
    with torch.cuda.device(dev):
        ptrs = (xc.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                A.data_ptr(), y.data_ptr(), h_last.data_ptr())
        if states:
            fn = (lib.selective_scan_states_f32 if xc.dtype == torch.float32
                  else lib.selective_scan_states_bf16)
            status = fn(*ptrs, chunk_h.data_ptr(), B, S, Di, N,
                        current_stream())
        else:
            fn = (lib.selective_scan_f32 if xc.dtype == torch.float32
                  else lib.selective_scan_bf16)
            status = fn(*ptrs, B, S, Di, N, current_stream())
    raise_on(status, "selective_scan")
    launches["selective_scan"] += 1
    if states:
        state_launches["selective_scan"] += 1
        if xc.dtype == torch.bfloat16:
            bf16_launches["selective_scan"] += 1
    return (y, h_last, chunk_h) if states else (y, h_last)


def bwd_lanes(N: int) -> int:
    """The backward's lanes a channel: N / 4 rounded up to a power of
    two."""
    lanes = 1
    while lanes * BWD_STATES < N:
        lanes *= 2
    return lanes


def bwd_channels(N: int) -> int:
    """The backward's channels a block: 64 channels of `bwd_lanes` lanes,
    at most 1024 (d, n) pairs (the .cu's kPairs) a block."""
    lanes = bwd_lanes(N)
    return min(64 * lanes, 1024 // BWD_STATES) // lanes


def bwd_scratch_floats(B: int, S: int, Di: int, N: int) -> int:
    """Floats of the backward's scratch: each block's partial sums of dBc
    and dCc (blocks, B, S, 2, N), then each b's dA (B, N, Di) from a
    multiple of 64 floats (the C interface's rule)."""
    blocks = -(-Di // bwd_channels(N))
    return -(-(blocks * B * S * 2 * N) // 64) * 64 + B * N * Di


def selective_scan_bwd(xc, dt, Bc, Cc, A, dy, dh_last=None, chunk_h=None):
    """The gradient of `selective_scan` at (xc, dt, Bc, Cc, A) given dy
    (B, S, Di) and d h_last (B, Di, N), or None when no gradient reaches
    the final state -> (dxc, ddt, dBc, dCc, dA) in the inputs' types (xc,
    dt, Bc, Cc and dy float32 or bfloat16, one type; A, dh_last and dA
    float32).  chunk_h: the forward's state entering each chunk, (chunks,
    B, N, Di) float32; without it the forward kernel runs first to write
    it."""
    B, S, Di = xc.shape
    flops, n_bytes = backward_cost(B, S, Di, A.shape[1], xc.element_size(),
                                   dh_last is not None)
    with kernel_work("selective_scan_bwd", flops, n_bytes):
        return _backward_call(xc, dt, Bc, Cc, A, dy, dh_last, chunk_h)


def _backward_call(xc, dt, Bc, Cc, A, dy, dh_last, chunk_h):
    if xc.device.type == "meta":
        _check(xc, dt, Bc, Cc, A, (torch.float32, torch.bfloat16))
        return tuple(torch.empty_like(t) for t in (xc, dt, Bc, Cc, A))
    if xc.device.type == "cpu":
        return selective_scan_bwd_ref(xc, dt, Bc, Cc, A, dy, dh_last)
    B, S, Di = xc.shape
    N = A.shape[1]
    f32 = torch.float32
    extra = [("dy", dy, (B, S, Di), xc.dtype)]
    if dh_last is not None:
        extra.append(("dh_last", dh_last, (B, Di, N), f32))
    if chunk_h is not None:
        extra.append(("chunk_h", chunk_h, (-(-S // CHUNK), B, N, Di), f32))
    _check(xc, dt, Bc, Cc, A, (torch.float32, torch.bfloat16), extra)
    dxc, ddt, dBc, dCc = (torch.empty_like(t) for t in (xc, dt, Bc, Cc))
    dA = torch.empty_like(A)
    if xc.numel() == 0:
        return dxc, ddt, dBc.zero_(), dCc.zero_(), dA.zero_()
    if chunk_h is None:
        chunk_h = _forward(xc, dt, Bc, Cc, A, states=True)[2]
    scratch = torch.empty((bwd_scratch_floats(B, S, Di, N),),
                          dtype=torch.float32, device=xc.device)
    lib = typed_library(BWD_SOURCE, _bwd_signatures)
    fn = (lib.selective_scan_bwd_states_f32 if xc.dtype == torch.float32
          else lib.selective_scan_bwd_states_bf16)
    with torch.cuda.device(xc.device):
        status = fn(
            xc.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
            A.data_ptr(), dy.data_ptr(),
            None if dh_last is None else dh_last.data_ptr(),
            chunk_h.data_ptr(), dxc.data_ptr(), ddt.data_ptr(),
            dBc.data_ptr(), dCc.data_ptr(), dA.data_ptr(), scratch.data_ptr(),
            B, S, Di, N, current_stream())
    raise_on(status, "selective_scan_bwd")
    launches["selective_scan_bwd"] += 1
    if xc.dtype == torch.bfloat16:
        bf16_launches["selective_scan_bwd"] += 1
    return dxc, ddt, dBc, dCc, dA


def _placeholder(t: torch.Tensor) -> bool:
    """A saved slot that holds no chunk states: all strides 0."""
    return all(st == 0 for st in t.stride())


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel, saving its inputs and (on the card) its chunk
    states, and the backward kernel given them.

    Inside `without_chunk_states` the chunk states' slot holds a zero-
    strided view of their shape: a checkpoint's recompute must save as
    many tensors, of the same shapes, as its first pass did.  A backward
    handed that view runs the forward for the states."""

    @staticmethod
    def forward(ctx, xc, dt, Bc, Cc, A):
        if xc.device.type == "cpu":
            y, h_last = _forward(xc, dt, Bc, Cc, A)
            chunk_h = None          # the plain backward recomputes them
        else:
            if _keep_states.get():
                y, h_last, chunk_h = _forward(xc, dt, Bc, Cc, A, states=True)
            else:
                y, h_last = _forward(xc, dt, Bc, Cc, A)
                B, S, Di = xc.shape
                chunk_h = xc.new_zeros((), dtype=torch.float32).expand(
                    -(-S // CHUNK), B, A.shape[1], Di)
        ctx.save_for_backward(xc, dt, Bc, Cc, A, chunk_h)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        *saved, chunk_h = ctx.saved_tensors   # unpacked once (the checkpoint)
        dy = torch.zeros_like(saved[0]) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        if chunk_h is not None and _placeholder(chunk_h):
            chunk_h = None
        return selective_scan_bwd(*saved, dy, dh_last, chunk_h)


def selective_scan(xc: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 recurrence h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,
    y_t = h_t C_t, h_{-1} = 0.  xc, dt: (B,S,Di); Bc, Cc: (B,S,N);
    A: (Di,N) float32 -> (y (B,S,Di) in xc's type, h_last (B,Di,N) f32).

    xc, dt, Bc and Cc are float32 or bfloat16, all one type; the state is
    carried in float32.  N is at most 64.  Differentiable (either type)
    when an input requires a gradient.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xc, dt, Bc, Cc, A)):
        return _SelectiveScan.apply(xc, dt, Bc, Cc, A)
    return _forward(xc, dt, Bc, Cc, A)
