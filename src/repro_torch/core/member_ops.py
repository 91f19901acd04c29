"""Per-member products and reductions of the round, as custom operators
whose batching rule runs each population member's slice on its own.

On the card a reduction or a product picks its launch configuration (how
a row is split over blocks, which GEMM kernel) from the whole tensor's
shape, so the same row summed inside a (B, M, N) batch and inside its
member's (M, N) tensor can round differently, and a population member
(`repro_torch.pop`) would drift from its standalone run.  Each operator
here takes one member's (M, N) rows, made contiguous; under
``torch.func.vmap`` its ``*_pop`` counterpart calls the same function on
each member's contiguous (M, N) slice, one launch a member, so every
member computes exactly what its standalone run computes.
"""
from __future__ import annotations

import torch

__all__ = ["gram", "row_sq_sum"]


def _gram(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x @ x.T


def _row_sq_sum(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return (x * x).sum(1)


@torch.library.custom_op("repro_torch::gram", mutates_args=())
def gram(x: torch.Tensor) -> torch.Tensor:
    """``x @ x.T`` for (M, N) float32 rows, in full float32 (TF32 is off
    in the port)."""
    return _gram(x)


@torch.library.custom_op("repro_torch::gram_pop", mutates_args=())
def gram_pop(x: torch.Tensor) -> torch.Tensor:
    """(P, M, N) -> (P, M, M): `gram` of each slice."""
    return torch.stack([_gram(xp) for xp in x.unbind(0)])


@torch.library.custom_op("repro_torch::row_sq_sum", mutates_args=())
def row_sq_sum(x: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (M,): each row's sum of squares."""
    return _row_sq_sum(x)


@torch.library.custom_op("repro_torch::row_sq_sum_pop", mutates_args=())
def row_sq_sum_pop(x: torch.Tensor) -> torch.Tensor:
    """(P, M, N) -> (P, M): `row_sq_sum` of each slice."""
    return torch.stack([_row_sq_sum(xp) for xp in x.unbind(0)])


@gram.register_fake
def _gram_fake(x):
    return x.new_empty((x.shape[0], x.shape[0]))


@gram_pop.register_fake
def _gram_pop_fake(x):
    return x.new_empty((x.shape[0], x.shape[1], x.shape[1]))


@row_sq_sum.register_fake
def _row_sq_sum_fake(x):
    return x.new_empty((x.shape[0],))


@row_sq_sum_pop.register_fake
def _row_sq_sum_pop_fake(x):
    return x.new_empty((x.shape[0], x.shape[1]))


def _per_member(single, batched):
    def rule(info, in_dims, x):
        if in_dims[0] is None:
            return single(x), None
        return batched(x.movedim(in_dims[0], 0)), 0
    return rule


gram.register_vmap(_per_member(gram, gram_pop))
row_sq_sum.register_vmap(_per_member(row_sq_sum, row_sq_sum_pop))


# DTensor sharding rule: under the partitioner-inferred placement
# (`repro_torch.api.placement`, ``impl='gspmd'``) the members' rows are
# replicated and each rank computes the whole product on its local tensor.
# Registered on first use of that placement.
_dtensor_rules = []


def register_dtensor_rules() -> None:
    """Register `gram`'s and `row_sq_sum`'s DTensor sharding rule (once)."""
    if _dtensor_rules:
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding([torch.ops.repro_torch.gram.default,
                        torch.ops.repro_torch.row_sq_sum.default])
    def _replicated(x):
        return [([Replicate()], [Replicate()])]

    _dtensor_rules.append(_replicated)
