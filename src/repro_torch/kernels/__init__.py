"""Hand-written CUDA kernels of the port, their plain versions and wrappers.

  csrc/trust_aggregate.cu   Eqn-6 and fused Eqn-6 + Eqn-19 aggregation
  build                     nvcc -> shared library -> ctypes, at first use
  trust_aggregate           checked wrappers with launch counters
  ref                       the plain PyTorch versions (CPU path, oracle)
  ops                       parameter-tree entry points, flat layout
"""
from .ops import (flatten_rows, layout_of, leaf_views,
                  trust_aggregate_global_tree, trust_aggregate_tree)
from .trust_aggregate import (launches, reset_launches, trust_aggregate,
                              trust_aggregate_global)

__all__ = ["trust_aggregate", "trust_aggregate_global", "trust_aggregate_tree",
           "trust_aggregate_global_tree", "flatten_rows", "layout_of",
           "leaf_views", "launches", "reset_launches"]
