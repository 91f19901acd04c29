"""The device an entry point of the port runs on."""
from __future__ import annotations

import sys

import torch


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, the partitioner-inferred placement's
    tensors (nothing is before DTensor's module is loaded, so this costs
    no import)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another.  Without a card, only an explicit ``device="cpu"`` runs.
    On the card, float32 products run in full precision (TF32 off)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run its plain versions on the CPU")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
