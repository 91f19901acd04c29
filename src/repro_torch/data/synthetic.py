"""Synthetic data sources (no dataset downloads).

``make_classification`` — the MNIST-shaped 10-class prototype task
(784-dim inputs, additive noise, class-dependent structure) in place of
MNIST.  The IoT telemetry source of the JAX package is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SyntheticClassification(NamedTuple):
    x: torch.Tensor       # (N, dim) float32
    y: torch.Tensor       # (N,) int64
    prototypes: torch.Tensor


def make_classification(generator: torch.Generator, n: int = 8192,
                        dim: int = 784, n_classes: int = 10,
                        noise: float = 0.8) -> SyntheticClassification:
    """Class prototypes plus Gaussian noise, drawn from ``generator`` (on
    the CPU, so a seed gives the same data on every device)."""
    protos = torch.randn((n_classes, dim), generator=generator)
    y = torch.randint(0, n_classes, (n,), generator=generator)
    x = protos[y] + noise * torch.randn((n, dim), generator=generator)
    return SyntheticClassification(x=x, y=y, prototypes=protos)
