"""The paper's device-scale model: a small MLP classifier (MNIST-shaped).

Parameters are a dict ``{w1 (dim, hidden), b1 (hidden,), w2 (hidden,
classes), b2 (classes,)}``.  Every function also takes a stacked dict with
a leading member dim ``M`` and then runs all members as one batched
product (``torch.bmm``), which is how the round trains a cluster.
"""
from __future__ import annotations

import math

import torch


def init_mlp_classifier(generator: torch.Generator, dim=784, hidden=200,
                        n_classes=10):
    """Gaussian weights scaled by 1/sqrt(fan_in), zero biases (on the CPU;
    the caller moves them)."""
    return {
        "w1": torch.randn((dim, hidden), generator=generator) / math.sqrt(dim),
        "b1": torch.zeros((hidden,)),
        "w2": torch.randn((hidden, n_classes), generator=generator)
        / math.sqrt(hidden),
        "b2": torch.zeros((n_classes,)),
    }


def _affine(x, w, b):
    if w.dim() == 3:                      # stacked members: (M, B, in)
        return torch.bmm(x, w) + b[:, None, :]
    return x @ w + b


def mlp_logits(params, x):
    h = torch.relu(_affine(x, params["w1"], params["b1"]))
    return _affine(h, params["w2"], params["b2"])


def mlp_hidden_mean(params, x):
    """tau(t): mean hidden-layer activation, part of the DQN state
    (§IV-B); (M,) for stacked params."""
    return torch.relu(_affine(x, params["w1"], params["b1"])).mean((-2, -1))


def classifier_losses(params, x, y):
    """Mean cross-entropy over the batch: a scalar, or (M,) for stacked
    params with x (M, B, dim), y (M, B)."""
    logits = mlp_logits(params, x)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y[..., None])[..., 0]
    return (logz - gold).mean(-1)


def accuracy(params, x, y):
    return (torch.argmax(mlp_logits(params, x), -1) == y).to(
        torch.float32).mean()
