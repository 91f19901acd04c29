"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — mamba-1 architecture.  [arXiv:2410.05355]

d_inner = 2*d_model = 8192, dt_rank = d_model/16 = 256, conv 4.  Every
layer is a MAMBA block; no MLP.  The same values as the JAX package's
``repro.configs.falcon_mamba_7b``.
"""
import dataclasses

from ..models.config import MAMBA, ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    vocab_size=65024,
    d_ff=0,
    block_pattern=(MAMBA,),
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    dt_rank=256,
    tie_embeddings=True,
    fl_mode="fedavg_replica",
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, dt_rank=8, vocab_size=512)
