"""Synthetic data and federated partitioning of the port."""
from .federated import (dirichlet_partition, padded_partition,
                        sample_member_batch)
from .synthetic import (SyntheticClassification, SyntheticTelemetry,
                        lm_batches, make_classification,
                        make_iot_telemetry, token_stream)

__all__ = ["dirichlet_partition", "padded_partition", "sample_member_batch",
           "SyntheticClassification", "SyntheticTelemetry",
           "make_classification", "make_iot_telemetry", "token_stream",
           "lm_batches"]
