"""MLP autoencoder for federated anomaly detection over IoT telemetry.

Each device trains a reconstruction model on its own, mostly normal,
telemetry; clusters aggregate through the same Eqn-6 trust machinery as
the classifier (learning quality and gradient diversity do not depend on
the loss), and anomalies show at inference as samples the global model
cannot reconstruct.  Parameters are a dict ``{w1..w4, b1..b4}``; every
function also takes a stacked dict with a leading member dim ``M`` and
then runs all members as one batched product, as `core.mlp` does.

Evaluation is threshold-free: `anomaly_auc` ranks reconstruction errors
against the ground-truth anomaly labels.
"""
from __future__ import annotations

import math

import torch

from .mlp import _affine


def init_mlp_autoencoder(generator: torch.Generator, dim: int,
                         hidden: int = 64, code: int = 8):
    """dim -> hidden -> code -> hidden -> dim, relu encoder, linear head:
    Gaussian weights scaled by 1/sqrt(fan_in), zero biases (on the CPU)."""
    n = lambda fan_in, fan_out: torch.randn(
        (fan_in, fan_out), generator=generator) / math.sqrt(fan_in)
    return {
        "w1": n(dim, hidden), "b1": torch.zeros((hidden,)),
        "w2": n(hidden, code), "b2": torch.zeros((code,)),
        "w3": n(code, hidden), "b3": torch.zeros((hidden,)),
        "w4": n(hidden, dim), "b4": torch.zeros((dim,)),
    }


def encode(params, x):
    h = torch.relu(_affine(x, params["w1"], params["b1"]))
    return torch.relu(_affine(h, params["w2"], params["b2"]))


def reconstruct(params, x):
    h = torch.relu(_affine(encode(params, x), params["w3"], params["b3"]))
    return _affine(h, params["w4"], params["b4"])


def code_mean(params, x):
    """tau(t): mean bottleneck activation, the reconstruction task's
    stand-in for the classifier's hidden-layer mean in the DQN state
    (§IV-B); (M,) for stacked params."""
    return encode(params, x).mean((-2, -1))


def reconstruction_errors(params, x):
    """Per-sample mean squared reconstruction error, the anomaly score:
    (N,), or (M, B) for stacked params."""
    return torch.mean((reconstruct(params, x) - x) ** 2, dim=-1)


def reconstruction_loss(params, x):
    """Mean squared reconstruction error over the batch: a scalar, or (M,)
    for stacked params.  Training is unsupervised: no labels enter."""
    return reconstruction_errors(params, x).mean(-1)


def anomaly_auc(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Rank AUC of anomaly scores against binary labels (1 = anomalous),
    a 0-d float64 tensor on the scores' device.

    Mann-Whitney form: (sum of anomaly ranks - n_pos (n_pos + 1) / 2) /
    (n_pos n_neg), with midranks for ties; NaN when either class is
    absent.  NaN scores (a diverged model) rank last and tied, as in the
    JAX package (all NaN: 0.5).  The ranks and sums are float64: the JAX
    package sums ranks of up to ~6.6e4 over thousands of anomalies in
    float32, near its integer limit, so the two agree to ~1e-6, not bit
    for bit.
    """
    scores = scores.to(torch.float32).reshape(-1)
    pos = (labels.reshape(-1) > 0).to(torch.float64)
    n_pos, n_neg = pos.sum(), (1.0 - pos).sum()
    sorted_scores, order = torch.sort(scores)
    base = torch.arange(1, scores.shape[0] + 1, dtype=torch.float64,
                        device=scores.device)
    # midranks: the mean 1-based position of each tie group.  NaN scores
    # (a diverged model) sort last and tie with each other, as in the JAX
    # package's sort and search
    nan = torch.isnan(sorted_scores)
    n = scores.shape[0]
    key = torch.where(nan, float("inf"), sorted_scores)  # sorted, no NaN
    first = torch.searchsorted(key, sorted_scores, right=False)
    last = torch.searchsorted(key, sorted_scores, right=True)
    n_num = n - nan.sum()
    first = torch.where(nan, n_num, first)
    last = torch.where(nan, n, torch.minimum(last, n_num))
    mid = 0.5 * (base[first] + base[last - 1])
    ranks = torch.empty_like(mid).scatter_(0, order, mid)
    auc = ((ranks * pos).sum() - n_pos * (n_pos + 1.0) / 2.0) / (
        n_pos * n_neg)
    return torch.where((n_pos > 0) & (n_neg > 0), auc, float("nan"))
