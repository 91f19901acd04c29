"""Round numerics of the port: twins, trust, energy, clustering, the
Lyapunov queue and the MLP, as plain functions on tensors."""
