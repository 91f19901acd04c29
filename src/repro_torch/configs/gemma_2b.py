"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000 — GeGLU, head_dim=256, MQA.  [arXiv:2403.08295]

Global causal attention only: the flash-attention kernel with window 0.
The same values as the JAX package's ``repro.configs.gemma_2b``.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    vocab_size=256000,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    activation="gelu",
    emb_scale=True,
    tie_embeddings=True,
    rope_theta=10000.0,
    sliding_variant_window=4096,
    fl_mode="fedavg_replica",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
    head_dim=32, d_ff=256, vocab_size=512)
