"""chameleon-34b [vlm] — 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion VQ image tokens.  [arXiv:2405.09818]

Frontend stub (the one permitted carve-out): Chameleon is *early-fusion* —
images are VQ-VAE token ids inside the same 65536 vocab, so the decoder
consumes plain token ids; the VQ tokenizer itself is stubbed and
``input_specs`` supplies interleaved text+image token ids.
Chameleon uses qk-norm for training stability (paper §2.2) — enabled.
FL mode A.  long_500k skipped (full attention).

The same values as the JAX package's ``repro.configs.chameleon_34b``.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    arch_type="vlm",
    num_layers=48,
    d_model=8192,
    vocab_size=65536,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    qk_norm=True,
    activation="silu",
    tie_embeddings=False,
    rope_theta=10000.0,
    fl_mode="fedavg_replica",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512)
