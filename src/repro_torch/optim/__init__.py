"""Optimizers of the port, as functions over dicts of tensors."""
from .optimizers import (REGISTRY, Optimizer, adafactor, adam, adamw,
                         apply_updates, clip_by_global_norm, global_norm, sgd)

__all__ = ["REGISTRY", "Optimizer", "adafactor", "adam", "adamw",
           "apply_updates", "clip_by_global_norm", "global_norm", "sgd"]
