"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160 routed top-6 + 2 shared, MLA kv_lora=512.
[arXiv:2405.04434]

MLA: q_lora_rank 1536, kv_lora_rank 512, qk_nope 128 + qk_rope 64,
v_head_dim 128.  Layer 0 is dense (d_ff 12288); layers 1-59 are MoE.
FL mode B (trust_fsdp) — 236B params.
long_500k skipped (full attention).

The same values as the JAX package's ``repro.configs.deepseek_v2_236b``.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    vocab_size=102400,
    num_heads=128,
    num_kv_heads=128,           # MLA: per-head K/V expanded from the latent
    d_ff=12288,                 # dense layer-0 width
    num_experts=160,
    num_shared_experts=2,
    topk=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mla_absorbed=True,
    activation="silu",
    tie_embeddings=False,
    rope_theta=10000.0,
    fl_mode="trust_fsdp",
    shard_scheme="ep_tp",
    scan_indexed=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=3, d_model=128, num_heads=4, d_ff=256,
    num_experts=4, num_shared_experts=1, topk=2, moe_d_ff=64,
    q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
    v_head_dim=16, num_kv_heads=4, vocab_size=512)
