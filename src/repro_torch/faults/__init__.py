"""Fault specs of the port (the spec only; the fault model is queued)."""
from .spec import FaultSpec

__all__ = ["FaultSpec"]
