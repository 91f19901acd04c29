"""The paper's own experimental model: the 784 -> 200 -> 10 MLP on
(synthetic) MNIST with a 48 x 200 x 10 DQN choosing the aggregation
frequency (§V), over 16 devices in 4 clusters.

Not a transformer: `repro_torch.core.AsyncFederation` and the paper's
figures (`repro_torch.paper`) run it.  The same values as the JAX
package's ``repro.configs.paper_mnist``.
"""
from ..core.async_fl import AsyncFLConfig
from ..core.dqn import DQNConfig

CONFIG = AsyncFLConfig(n_devices=16, n_clusters=4)
SMOKE = AsyncFLConfig(n_devices=4, n_clusters=2, sim_seconds=4.0,
                      local_batch=16)
DQN = DQNConfig()
