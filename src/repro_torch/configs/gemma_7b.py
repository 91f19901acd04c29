"""gemma-7b [dense] — 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000 — GeGLU, head_dim=256.  [arXiv:2403.08295]

Tied embeddings scaled by sqrt(d_model).  long_500k uses the
sliding-window-4096 serving variant.  FL mode A.

The same values as the JAX package's ``repro.configs.gemma_7b``.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3072,
    vocab_size=256000,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    activation="gelu",
    emb_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    sliding_variant_window=4096,
    fl_mode="fedavg_replica",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512)
