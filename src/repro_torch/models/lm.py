"""Language-model losses over the port's transformer (the JAX package's
``models/lm.py``).

``lm_loss`` and ``weighted_lm_loss`` take the `LM` and, optionally, a
``params`` dict in place of its own parameters (`LM.forward`), so the
federated step computes every client's loss on one model.  A model with
MoE layers adds ``MOE_AUX_WEIGHT`` times their Switch loss, as the JAX
package does (`LM.forward_aux`).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from .transformer import LM

MOE_AUX_WEIGHT = 0.01


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits (..., V), labels (...)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def lm_loss(model: LM, batch: Mapping[str, torch.Tensor], *,
            params: Optional[Mapping[str, torch.Tensor]] = None,
            remat: bool = True) -> torch.Tensor:
    """batch = {"tokens": (B,S) or (B,K,S), "labels": the same shape} ->
    the scalar loss."""
    logits, aux = model.forward_aux(batch["tokens"], params, remat)
    return _with_aux(model, xent(logits, batch["labels"]), aux)


def _with_aux(model: LM, loss: torch.Tensor, aux: torch.Tensor
              ) -> torch.Tensor:
    return loss + MOE_AUX_WEIGHT * aux if model.cfg.num_experts else loss


def weighted_lm_loss(model: LM, batch: Mapping[str, torch.Tensor],
                     example_weights: torch.Tensor, *,
                     params: Optional[Mapping[str, torch.Tensor]] = None,
                     remat: bool = True) -> torch.Tensor:
    """Trust-weighted loss (federated mode B): per-example weights make the
    gradient the trust-weighted aggregate.  example_weights: (B,)
    normalized trust weights of each example's client."""
    logits, aux = model.forward_aux(batch["tokens"], params, remat)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        batch["labels"][..., None].long())[..., 0]
    per_tok = logz - gold
    w = example_weights.to(torch.float32)
    while w.dim() < per_tok.dim():
        w = w[..., None]
    return _with_aux(model, (per_tok * w).sum()
                     / (w.expand_as(per_tok).sum() + 1e-9), aux)
