"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1]

Grok-1 details from the model card: attention-logit tanh softcap 30,
head_dim 128, untied embeddings.  314B total / ~86B active params.
FL mode B (trust_fsdp): a replica per client does not fit.

The same values as the JAX package's ``repro.configs.grok_1_314b``.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    vocab_size=131072,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,                 # dense width (unused: all layers MoE)
    num_experts=8,
    topk=2,
    moe_d_ff=32768,
    activation="gelu",
    attn_softcap=30.0,
    tie_embeddings=False,
    rope_theta=10000.0,
    fl_mode="trust_fsdp",
    shard_scheme="fsdp_tp",
    scan_indexed=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, moe_d_ff=256, num_experts=4, topk=2,
    vocab_size=512)
