"""Round numerics of the port: twins, trust, energy, clustering, the
Lyapunov queue, the MLP and the autoencoder, and the DQN with the
DT-simulated environment it trains in, as plain functions on tensors."""
from .autoencoder import (anomaly_auc, code_mean, encode,
                          init_mlp_autoencoder, reconstruct,
                          reconstruction_errors, reconstruction_loss)
from .dqn import (DQNConfig, DQNState, Replay, dqn_params_from_numpy,
                  epsilon, init_dqn, q_values, select_action, store,
                  train_step as dqn_train_step)
from .envs import N_ACTIONS, OBS_DIM, EnvParams, EnvState

__all__ = ["anomaly_auc", "code_mean", "encode", "init_mlp_autoencoder",
           "reconstruct", "reconstruction_errors", "reconstruction_loss",
           "DQNConfig", "DQNState", "Replay", "dqn_params_from_numpy",
           "epsilon", "init_dqn", "q_values", "select_action", "store",
           "dqn_train_step", "N_ACTIONS", "OBS_DIM", "EnvParams",
           "EnvState"]
