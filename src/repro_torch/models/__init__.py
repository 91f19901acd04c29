"""Language models of the port: config schema, layers and the LM."""
from .config import ATTN, LOCAL, MAMBA, RGLRU, ArchConfig
from .lm import lm_loss, weighted_lm_loss, xent
from .transformer import (LM, named_from_tree, params_from_numpy,
                          params_to_numpy, tree_from_named, unstack_layers)

__all__ = ["ArchConfig", "ATTN", "LOCAL", "MAMBA", "RGLRU", "LM",
           "params_from_numpy", "params_to_numpy", "named_from_tree",
           "tree_from_named", "unstack_layers", "xent",
           "lm_loss", "weighted_lm_loss"]
