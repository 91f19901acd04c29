"""Hand-written CUDA kernels of the port, their plain versions and wrappers.

  csrc/trust_aggregate.cu   Eqn-6 and fused Eqn-6 + Eqn-19 aggregation
  csrc/flash_attention.cu   causal (sliding-window, soft-capped) attention
  csrc/flash_attention_bwd.cu   its backward (dQ, dK, dV)
  csrc/rglru_scan.cu        the RG-LRU gated linear recurrence
  csrc/rglru_scan_bwd.cu    its backward (the reverse scan)
  csrc/selective_scan.cu    the Mamba-1 selective scan
  csrc/selective_scan_bwd.cu    its backward (from the chunk states)
  build                     nvcc -> shared library -> ctypes, at first use
  launch                    launch counters and the C-call helpers
  trust_aggregate, flash_attention, rglru_scan, selective_scan
                            checked wrappers (trust_aggregate also holds
                            the population-batched ones; flash_attention,
                            rglru_scan and selective_scan their
                            backwards, as torch.autograd.Functions)
  ref                       the plain PyTorch versions (CPU path, oracle)
  ops                       entry points for the models and the federation
"""
from .flash_attention import flash_attention, flash_attention_bwd
from .launch import bf16_launches, launches, reset_launches
from .ops import (attention, flatten_rows, layout_of, leaf_views, lru_scan,
                  mamba_scan, trust_aggregate_global_tree,
                  trust_aggregate_tree)
from .rglru_scan import rglru_scan, rglru_scan_bwd
from .selective_scan import (selective_scan, selective_scan_bwd,
                             state_launches, without_chunk_states)
from .trust_aggregate import (trust_aggregate, trust_aggregate_global,
                              trust_aggregate_global_pop,
                              trust_aggregate_pop)

__all__ = ["trust_aggregate", "trust_aggregate_global", "trust_aggregate_tree",
           "trust_aggregate_pop", "trust_aggregate_global_pop",
           "trust_aggregate_global_tree", "flatten_rows", "layout_of",
           "leaf_views", "launches", "bf16_launches", "reset_launches",
           "flash_attention",
           "flash_attention_bwd", "rglru_scan", "rglru_scan_bwd",
           "selective_scan", "selective_scan_bwd", "state_launches",
           "without_chunk_states", "attention", "lru_scan", "mamba_scan"]
