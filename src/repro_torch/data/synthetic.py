"""Synthetic data sources (no dataset downloads).

``make_classification`` — the MNIST-shaped 10-class prototype task
(784-dim inputs, additive noise, class-dependent structure) in place of
MNIST.  ``make_iot_telemetry`` — non-IID industrial-IoT sensor telemetry
for the federated anomaly-detection task: each device type (equipment
family) emits readings on its own low-dimensional operating manifold, and
a small fraction of samples carry injected faults; ``device_type`` is the
non-IID partition key.  ``token_stream`` — Zipf-distributed token ids for
the language models; ``lm_batches`` — next-token batches from it.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, NamedTuple

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


class SyntheticTelemetry(NamedTuple):
    x: torch.Tensor            # (N, dim) float32 sensor feature vectors
    y: torch.Tensor            # (N,) int64, 1 = anomalous sample
    device_type: torch.Tensor  # (N,) int64 equipment family


def make_iot_telemetry(generator: torch.Generator, n: int = 2048,
                       dim: int = 32, n_types: int = 8, latent: int = 4,
                       anomaly_frac: float = 0.05, noise: float = 0.05,
                       spike: float = 4.0, spike_frac: float = 0.25
                       ) -> SyntheticTelemetry:
    """IIoT telemetry with type-structured normals and injected faults,
    drawn from ``generator`` (on the CPU).

    Device type t has an operating point ``mean_t`` and a ``latent``-dim
    loading matrix ``A_t``; a normal reading is ``mean_t + z A_t +
    noise``, near a ``latent``-dimensional affine manifold an autoencoder
    can learn.  A Bernoulli(anomaly_frac) subset of samples also gets
    heavy spikes on a random ``spike_frac`` of its coordinates (stuck or
    drifting sensors), labelled ``y = 1``.  Anomalies stay in the training
    stream; the labels are for evaluation only.
    """
    types = torch.randint(0, n_types, (n,), generator=generator)
    means = 2.0 * torch.randn((n_types, dim), generator=generator)
    loadings = torch.randn((n_types, latent, dim),
                           generator=generator) / math.sqrt(latent)
    z = torch.randn((n, latent), generator=generator)
    x = means[types] + torch.bmm(z[:, None, :], loadings[types])[:, 0]
    x = x + noise * torch.randn((n, dim), generator=generator)
    is_anom = torch.rand((n,), generator=generator) < anomaly_frac
    coord = torch.rand((n, dim), generator=generator) < spike_frac
    x = x + (is_anom[:, None] & coord) * spike * torch.randn(
        (n, dim), generator=generator)
    return SyntheticTelemetry(x=x, y=is_anom.to(torch.int64),
                              device_type=types)


def token_stream(generator: torch.Generator, n_tokens: int, vocab: int,
                 zipf_a: float = 1.2) -> torch.Tensor:
    """(n_tokens,) int64 Zipf-distributed token ids, p(rank r) ~ r^-a,
    drawn from ``generator`` (a realistic rank-frequency for LM smokes)."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
    p = ranks ** -zipf_a
    return torch.multinomial(p / p.sum(), n_tokens, replacement=True,
                             generator=generator)


def lm_batches(generator: torch.Generator, vocab: int, batch: int, seq: int,
               n_batches: int, codebooks: int = 1
               ) -> Iterator[Dict[str, torch.Tensor]]:
    """Next-token-prediction batches from a synthetic stream: ``tokens``
    and ``labels`` (B, S) (or (B, K, S) with codebooks), the labels the
    tokens shifted by one."""
    for _ in range(n_batches):
        shape = ((batch, seq + 1) if codebooks == 1
                 else (batch, codebooks, seq + 1))
        toks = token_stream(generator, math.prod(shape), vocab
                            ).reshape(shape)
        yield {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
