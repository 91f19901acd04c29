"""PyTorch / CUDA port of the federation, beside the JAX package ``repro``.

The same module names as ``repro``; the trust-aggregation kernels are
written by hand in CUDA C++ for Hopper (``kernels/csrc``).  Entry points
run on the card unless the caller passes ``device="cpu"``.

    from repro_torch.api import Federation, FederationSpec
"""
