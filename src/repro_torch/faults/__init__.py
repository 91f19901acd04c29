"""Fault injection of the port: the declarative `FaultSpec` and the
`FaultModel` that applies it inside the device-scale round (dropout,
stragglers, twin spikes, update corruption, input poisoning)."""
from .model import FaultModel
from .spec import CORRUPT_MODES, FaultSpec

__all__ = ["FaultSpec", "FaultModel", "CORRUPT_MODES"]
