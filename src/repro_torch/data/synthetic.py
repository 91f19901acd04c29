"""Synthetic data sources (no dataset downloads).

``make_classification`` — the MNIST-shaped 10-class prototype task
(784-dim inputs, additive noise, class-dependent structure) in place of
MNIST.  ``token_stream`` — Zipf-distributed token ids for the language
models.  The IoT telemetry source of the JAX package is not ported yet.
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


def token_stream(generator: torch.Generator, n_tokens: int, vocab: int,
                 zipf_a: float = 1.2) -> torch.Tensor:
    """(n_tokens,) int64 Zipf-distributed token ids, p(rank r) ~ r^-a,
    drawn from ``generator`` (a realistic rank-frequency for LM smokes)."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
    p = ranks ** -zipf_a
    return torch.multinomial(p / p.sum(), n_tokens, replacement=True,
                             generator=generator)
