"""Language-model losses over the port's transformer (the JAX package's
``models/lm.py``).

``lm_loss`` and ``weighted_lm_loss`` take the `LM` and, optionally, a
``params`` dict in place of its own parameters (`LM.forward`), so the
federated step computes every client's loss on one model.  MoE's
auxiliary term has no counterpart: MoE configs raise in `LM`.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from .transformer import LM


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits (..., V), labels (...)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def lm_loss(model: LM, batch: Mapping[str, torch.Tensor], *,
            params: Optional[Mapping[str, torch.Tensor]] = None,
            remat: bool = True) -> torch.Tensor:
    """batch = {"tokens": (B,S), "labels": (B,S)} -> the scalar loss."""
    logits = model(batch["tokens"], params=params, remat=remat)
    return xent(logits, batch["labels"])


def weighted_lm_loss(model: LM, batch: Mapping[str, torch.Tensor],
                     example_weights: torch.Tensor, *,
                     params: Optional[Mapping[str, torch.Tensor]] = None,
                     remat: bool = True) -> torch.Tensor:
    """Trust-weighted loss (federated mode B): per-example weights make the
    gradient the trust-weighted aggregate.  example_weights: (B,)
    normalized trust weights of each example's client."""
    logits = model(batch["tokens"], params=params, remat=remat)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        batch["labels"][..., None].long())[..., 0]
    per_tok = logz - gold
    w = example_weights.to(torch.float32)
    while w.dim() < per_tok.dim():
        w = w[..., None]
    return (per_tok * w).sum() / (w.expand_as(per_tok).sum() + 1e-9)
