"""What every kernel wrapper shares: launch counters, the loaded library
with its C signatures, the current stream and the error check.

Each launch of a kernel adds one to ``launches[<kernel name>]``, and only a
launch does: a run resets the counts, drives a path, and reads them to show
that the path went through the kernels.

A wrapper also reports each call's kernel work (its operations and bytes,
from the shapes: `kernel_work`) to the innermost active op counter
(`repro_torch.launch.op_stats`), on every device: on the meta device,
where a wrapper builds and launches nothing and returns outputs of the
kernel's shapes and types, that is the only trace a kernel leaves.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List

import torch

from . import build

P = ctypes.c_void_p             # a device pointer or the stream

launches: Dict[str, int] = {"trust_aggregate": 0,
                            "trust_aggregate_dense": 0,
                            "trust_aggregate_global": 0,
                            "trust_aggregate_pop": 0,
                            "trust_aggregate_dense_pop": 0,
                            "trust_aggregate_global_pop": 0,
                            "flash_attention": 0,
                            "flash_attention_bwd": 0,
                            "rglru_scan": 0,
                            "rglru_scan_bwd": 0,
                            "selective_scan": 0,
                            "selective_scan_bwd": 0}


# active op counters, innermost last (`repro_torch.launch.op_stats.OpStats`
# pushes itself while it is entered)
counters: List = []


def kernel_work(name: str, flops: float, n_bytes: float):
    """The context of one kernel call by a wrapper: the innermost active
    counter counts ``flops`` and ``n_bytes`` for kernel ``name`` and none
    of the ops inside (the plain version's, on the CPU), keeping only the
    storages that leave it (the outputs).  No counter: nothing."""
    if not counters:
        return contextlib.nullcontext()
    return counters[-1].kernel(name, flops, n_bytes)


# of those, the launches of the bfloat16 instances that training at the
# plans' bfloat16 added (the forward with lse, the chunk states' forward
# and the backwards): each such launch adds one here as well
bf16_launches: Dict[str, int] = {"flash_attention": 0,
                                 "flash_attention_bwd": 0,
                                 "rglru_scan_bwd": 0, "selective_scan": 0,
                                 "selective_scan_bwd": 0}


def reset_launches() -> None:
    for counts in (launches, bf16_launches):
        for k in counts:
            counts[k] = 0


def typed_library(source: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """The library of ``csrc/<source>`` (built at first use), with the
    argument types of its C functions set once."""
    lib = build.load(source)
    if not getattr(lib, "_typed", False):
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


def current_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def raise_on(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {status}")
