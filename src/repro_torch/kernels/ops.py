"""Entry points of the kernels for the modules that call them.

The attention, RG-LRU and Mamba layers of the language models call
`attention`, `lru_scan` and `mamba_scan`.  The federation calls the
parameter-tree entry points of the aggregation kernels, over a flat
layout:

A parameter tree is a dict of tensors.  Its flat form concatenates the
leaves in sorted-key order, which is ``jax.tree.leaves``' order for a dict,
so a flat vector of the port compares element for element with the JAX
package's ``_flatten_params`` (for the MLP: ``b1, b2, w1, w2``).  The
engine keeps its cluster and global models flat and reads leaves through
views (`leaf_views`), so the kernels read the parameters in place; the tree
functions below concatenate, as the JAX package's ``_flatten_rows`` does.

A population (`repro_torch.pop`) calls the same entry points under
``torch.func.vmap``; their batching rules launch the population-batched
kernels, `trust_aggregate_pop` and `trust_aggregate_global_pop`, which are
exposed here too.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .flash_attention import flash_attention
from .rglru_scan import rglru_scan
from .selective_scan import selective_scan
from .trust_aggregate import (trust_aggregate, trust_aggregate_global,
                              trust_aggregate_global_pop,  # noqa: F401
                              trust_aggregate_pop)  # noqa: F401

Layout = List[Tuple[str, Tuple[int, ...], int]]   # (key, leaf shape, offset)


def layout_of(tree: Dict[str, torch.Tensor], lead: int = 0) -> Layout:
    """Sorted-key layout of ``tree``; ``lead`` leading dims are not part of
    a leaf's shape (1 for a stack of rows)."""
    out, off = [], 0
    for k in sorted(tree):
        shape = tuple(tree[k].shape[lead:])
        out.append((k, shape, off))
        off += int(torch.Size(shape).numel())
    return out


def flatten_rows(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(rows, ...) leaves -> one (rows, N) float32 matrix, sorted-key order."""
    rows = next(iter(tree.values())).shape[0]
    return torch.cat([tree[k].reshape(rows, -1).to(torch.float32)
                      for k in sorted(tree)], dim=1)


def leaf_views(flat: torch.Tensor, layout: Layout) -> Dict[str, torch.Tensor]:
    """Views of a (..., N) flat buffer as the tree's leaves (no copy)."""
    lead = flat.shape[:-1]
    return {k: flat[..., off:off + int(torch.Size(shape).numel())]
            .view(*lead, *shape) for k, shape, off in layout}


def trust_aggregate_tree(client_params, weights, mask=None):
    """Eqn 6 over a tree with a leading client dim, via the kernel.
    ``mask`` (C,) selects valid rows (padded fixed-shape cluster rounds)."""
    flat = flatten_rows(client_params)
    agg = trust_aggregate(flat, weights.to(torch.float32),
                          None if mask is None else mask.to(torch.float32))
    return {k: v.to(client_params[k].dtype) for k, v in
            leaf_views(agg, layout_of(client_params, lead=1)).items()}


def trust_aggregate_global_tree(client_params, weights, mask, cluster_stack,
                                global_weights, c):
    """Fused Eqn 6 + Eqn 19 over trees: member parameters (leading dim C)
    and the stacked cluster parameters (leading dim B) -> the staleness-
    weighted global model, in one kernel pass.  ``c`` is the cluster whose
    Eqn-6 aggregate replaces its stack row."""
    stack = flatten_rows(cluster_stack)
    c = torch.as_tensor(c, dtype=torch.int32, device=stack.device)
    glob = trust_aggregate_global(
        flatten_rows(client_params), weights.to(torch.float32),
        mask.to(torch.float32), stack, global_weights.to(torch.float32), c)
    return {k: v.to(cluster_stack[k].dtype) for k, v in
            leaf_views(glob, layout_of(cluster_stack, lead=1)).items()}


def attention(q, k, v, *, window: int = 0, softcap: float = 0.0):
    """Causal attention of a layer, (B,S,H,d) queries against (B,S,Kv,d)
    keys and (B,S,Kv,dv) values, through the flash-attention kernel; the
    scores never reach device memory."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           window=window, softcap=softcap)


def lru_scan(a, bx):
    """The RG-LRU recurrence h_t = a_t h_{t-1} + bx_t over (B,S,W), through
    the scan kernel -> (hs, h_last)."""
    return rglru_scan(a.contiguous(), bx.contiguous())


def mamba_scan(xc, dt, Bc, Cc, A):
    """The Mamba-1 selective scan over (B,S,Di) with (B,S,N) B and C and a
    (Di,N) A, through the scan kernel -> (y, h_last); differentiable
    through the backward kernel (float32) when an input needs a gradient.
    """
    return selective_scan(xc.contiguous(), dt.contiguous(), Bc.contiguous(),
                          Cc.contiguous(), A.contiguous())
