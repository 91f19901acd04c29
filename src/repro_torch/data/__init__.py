"""Synthetic data and federated partitioning of the port."""
from .federated import (dirichlet_partition, padded_partition,
                        sample_member_batch)
from .synthetic import SyntheticClassification, make_classification

__all__ = ["dirichlet_partition", "padded_partition", "sample_member_batch",
           "SyntheticClassification", "make_classification"]
