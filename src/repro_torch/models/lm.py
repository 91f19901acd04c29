"""Language-model losses over the port's transformer (the JAX package's
``models/lm.py``).

``lm_loss`` and ``weighted_lm_loss`` take the `LM` and, optionally, a
``params`` dict in place of its own parameters (`LM.forward`), so the
federated step computes every client's loss on one model.  A model with
MoE layers adds ``MOE_AUX_WEIGHT`` times their Switch loss, as the JAX
package does (`LM.forward_aux`).

The cross-entropy is the vocab-parallel one: the max and the sum of
exponentials over the vocab, and the gold logit, each reduced over the
vocab's axes.  So in a sharded training step (``shards``,
`repro_torch.core.sharding`), where the logits are this rank's vocab
columns, no rank holds the (tokens x vocab) logits of the whole vocab;
unsharded, the reductions are over one rank.  The loss returned
is then this rank's *share*: the shares of all ranks of the step's group
sum to the loss (its gradient is the summed loss's, `sharding`'s module
notes).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from .modules import share
from .transformer import LM

MOE_AUX_WEIGHT = 0.01


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits (..., V), labels (...)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def vocab_parallel_xent(logits: torch.Tensor, labels: torch.Tensor,
                        offset: int, shards, axes) -> torch.Tensor:
    """Per-token cross-entropy (...,) from this rank's vocab columns
    ``logits`` (..., V_local), its first id ``offset``: the max, the sum
    of exponentials and the gold logit reduced over ``axes`` (none: the
    whole vocab's cross-entropy)."""
    from ..core.sharding import all_reduce_
    logits = logits.to(torch.float32)
    m = logits.detach().amax(dim=-1, keepdim=True)
    all_reduce_(m, shards.group(axes), torch.distributed.ReduceOp.MAX)
    se = shards.reduce((logits - m).exp_().sum(-1), axes)
    ids = labels.long() - offset
    inside = (ids >= 0) & (ids < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(
        inside, ids, torch.zeros_like(ids))[..., None])[..., 0]
    gold = shards.reduce(gold * inside.to(gold.dtype), axes)
    return m[..., 0] + torch.log(se) - gold


def _per_token(model: LM, logits, labels, shards) -> torch.Tensor:
    """The per-token cross-entropy of ``shards``' vocab columns."""
    return vocab_parallel_xent(
        logits, labels, model.vocab_offset(logits.shape[-1], shards),
        shards, model._vocab_axes(shards))


def _share(model: LM, loss, aux, shards) -> torch.Tensor:
    """A rank's share of ``loss + MOE_AUX_WEIGHT * aux``: ``loss`` is the
    same on the ranks of the tensor-parallel axes, the Switch loss on
    every rank of the step's group (one rank unsharded: the loss)."""
    loss = loss / shards.size(shards.tp)
    if model.cfg.num_experts:
        loss = loss + MOE_AUX_WEIGHT * aux / shards.size(
            shards.compute_axes)
    return loss


def lm_loss(model: LM, batch: Mapping[str, torch.Tensor], *,
            params: Optional[Mapping[str, torch.Tensor]] = None,
            remat: bool = True, shards=None) -> torch.Tensor:
    """batch = {"tokens": (B,S) or (B,K,S), "labels": the same shape} ->
    the scalar loss (with ``shards``, this rank's share: module notes)."""
    sh = share(shards)
    logits, aux = model.forward_aux(batch["tokens"], params, remat, sh)
    per_tok = _per_token(model, logits, batch["labels"], sh)
    return _share(model, per_tok.mean() / sh.size(sh.tokens), aux, sh)


def weighted_lm_loss(model: LM, batch: Mapping[str, torch.Tensor],
                     example_weights: torch.Tensor, *,
                     params: Optional[Mapping[str, torch.Tensor]] = None,
                     remat: bool = True, shards=None) -> torch.Tensor:
    """Trust-weighted loss (federated mode B): per-example weights make the
    gradient the trust-weighted aggregate.  example_weights: (B,)
    normalized trust weights of each example's client.  With ``shards``
    the batch rows split over the tokens' axes: the weights' sum is
    reduced over them, and the loss is this rank's share."""
    from ..core.sharding import all_reduce_
    sh = share(shards)
    logits, aux = model.forward_aux(batch["tokens"], params, remat, sh)
    per_tok = _per_token(model, logits, batch["labels"], sh)
    w = example_weights.to(torch.float32)
    while w.dim() < per_tok.dim():
        w = w[..., None]
    den = w.expand_as(per_tok).sum()
    all_reduce_(den, sh.group(sh.tokens))
    return _share(model, (per_tok * w).sum() / (den + 1e-9), aux, sh)
