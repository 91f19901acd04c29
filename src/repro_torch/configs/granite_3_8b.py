"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 — GQA.  [hf:ibm-granite/granite-3.0-2b-base family]

long_500k uses the sliding-window-4096 serving variant.  FL mode A.

The same values as the JAX package's ``repro.configs.granite_3_8b``.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    vocab_size=49155,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    activation="silu",
    tie_embeddings=True,
    rope_theta=10000.0,
    sliding_variant_window=4096,
    fl_mode="fedavg_replica",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512)
