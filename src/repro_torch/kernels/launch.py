"""What every kernel wrapper shares: launch counters, the loaded library
with its C signatures, the current stream and the error check.

Each launch of a kernel adds one to ``launches[<kernel name>]``, and only a
launch does: a run resets the counts, drives a path, and reads them to show
that the path went through the kernels.
"""
from __future__ import annotations

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


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
