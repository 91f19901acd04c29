"""Language models of the port: config schema, layers and the LM."""
from .config import ATTN, LOCAL, MAMBA, RGLRU, ArchConfig
from .transformer import LM, params_from_numpy, unstack_layers

__all__ = ["ArchConfig", "ATTN", "LOCAL", "MAMBA", "RGLRU", "LM",
           "params_from_numpy", "unstack_layers"]
