"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284]

Frontend stub (permitted carve-out): the EnCodec neural codec is stubbed —
``input_specs`` supplies K=4 parallel codebook token streams (the delay
pattern's flattened form); the model sums the 4 codebook embeddings and
predicts 4 parallel heads.  MusicGen uses plain MHA (kv=32) and learned
positions; we use RoPE as the substrate's positional scheme (noted
adaptation).  FL mode A.  long_500k skipped (full attention).

The same values as the JAX package's ``repro.configs.musicgen_large``.
"""
import dataclasses

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    vocab_size=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    activation="gelu",
    num_codebooks=4,
    tie_embeddings=False,
    fl_mode="fedavg_replica",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=256)
