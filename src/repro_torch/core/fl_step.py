"""The serving step of the JAX package's ``core/fl_step.py``.  (Its
training modes A/B are not ported yet: ROADMAP queue 1, item 10.)"""
from __future__ import annotations

from typing import Callable

from ..models.transformer import LM


def build_serve_step(model: LM) -> Callable:
    """serve_step(cache, tokens, step) -> (logits, cache): one decode step
    of ``model`` (plain decode; federated learning is train-time)."""
    def serve_step(cache, tokens, step: int):
        return model.decode_step(cache, tokens, step)
    return serve_step
