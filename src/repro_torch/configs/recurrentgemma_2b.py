"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1:2 ratio.  [arXiv:2402.19427]

Griffin block pattern (recurrent, recurrent, local-attention) repeated;
26 = 8 x 3 + 2, the trailing two layers recurrent.  Local attention window
2048, head_dim 256, MQA (kv=1).  The same values as the JAX package's
``repro.configs.recurrentgemma_2b``.
"""
import dataclasses

from ..models.config import LOCAL, RGLRU, ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,
    d_model=2560,
    vocab_size=256000,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    activation="gelu",
    block_pattern=(RGLRU, RGLRU, LOCAL),
    window=2048,
    lru_width=2560,
    ssm_conv=4,
    emb_scale=True,
    tie_embeddings=True,
    fl_mode="fedavg_replica",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=5, d_model=128, num_heads=4, num_kv_heads=1,
    head_dim=32, d_ff=256, lru_width=128, window=64, vocab_size=512)
