"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B family card]

Long-context serving (long_500k) uses the sliding-window-4096 variant.
FL mode A.

The same values as the JAX package's ``repro.configs.qwen1_5_32b``.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    vocab_size=152064,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    qkv_bias=True,
    activation="silu",
    tie_embeddings=False,
    rope_theta=1000000.0,
    sliding_variant_window=4096,
    fl_mode="fedavg_replica",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512)
