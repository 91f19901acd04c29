"""Pluggable federation components of the port and their registry entries.

Aggregator        ``__call__(client_flat, weights, mask=None) -> (N,)``
                  over a (C, N) flat parameter matrix; ``supports_mask``
                  says it understands a (C,) validity mask, so the engine
                  runs it on padded fixed-shape clusters.
                  ``aggregate_with_global`` folds the Eqn-19 global
                  average into the same kernel pass; the engine calls it
                  once per round.
FrequencyController
                  ``select(ctx) -> int`` raw a_i before the Alg.-2 bound;
                  ``observe(ctx, consumed, loss)`` after the round;
                  ``n_actions`` caps a_i; ``needs_ctx`` False lets the
                  engine skip reading the context back from the card;
                  ``scan_policy()`` the device-side twin for `run_scanned`.
TaskAdapter       model plug over flat parameter vectors: init, batched
                  local training, per-member losses, evaluation.

Ported: the trust / fedavg aggregator, the fixed and Lyapunov controllers
and the MLP task.  The DQN controller, the robust rules and the
autoencoder task are queued in ROADMAP.md; `FederationSpec.validate`
raises on them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch.control import policy as ctl_policy
from repro_torch.core.lyapunov import init_queue, step_queue
from repro_torch.core.mlp import (accuracy, classifier_losses,
                                  init_mlp_classifier)
from repro_torch.kernels.ops import flatten_rows, layout_of, leaf_views
from repro_torch.kernels.trust_aggregate import (trust_aggregate,
                                                 trust_aggregate_global)

from .registry import (register_aggregator, register_controller,
                       register_task)


class ControllerCtx(NamedTuple):
    """What a host-side frequency controller may look at when choosing a_i."""
    round: int                       # global round counter
    cluster: int                     # cluster index being scheduled
    cluster_loss: float              # mean twin loss over the cluster
    cluster_freq: float              # straggler (min) calibrated frequency
    mean_freq: float                 # mean calibrated frequency in cluster
    channel_good_frac: float         # fraction of members in the good state
    energy_used: float               # cumulative energy so far


# --------------------------------------------------------------------- #
# aggregators (Eqn 6)
# --------------------------------------------------------------------- #
class WeightedAggregator:
    """Trust / uniform weighted average through the CUDA trust-aggregation
    kernels (their plain versions for CPU tensors).  Mask-aware: padded
    client rows carry zero weight.

    The spec's ``use_kernel`` flag is accepted and ignored: the JAX package
    uses it to pick a jnp version of the same sums, while the port always
    launches its kernel on the card."""

    supports_mask = True

    def __init__(self, uniform: bool = False):
        self.uniform = uniform

    def _effective_weights(self, weights, mask):
        if not self.uniform:
            return weights
        if mask is None:
            return torch.full_like(weights, 1.0 / weights.shape[0])
        m = mask.to(weights.dtype)
        return m / torch.clamp(m.sum(), min=1.0)

    def __call__(self, client_flat, weights, mask=None):
        weights = self._effective_weights(weights, mask).to(torch.float32)
        return trust_aggregate(
            client_flat, weights,
            None if mask is None else mask.to(torch.float32))

    def aggregate_with_global(self, client_flat, weights, mask, stack_flat,
                              staleness_w, c):
        """Fused Eqn 6 + Eqn 19 in one `trust_aggregate_global` pass: the
        Eqn-6 aggregate of the (C, N) member parameters replaces row ``c``
        of the (B, N) stack before the staleness-weighted average."""
        weights = self._effective_weights(weights, mask).to(torch.float32)
        return trust_aggregate_global(
            client_flat, weights, mask.to(torch.float32), stack_flat,
            staleness_w.to(torch.float32), c.to(torch.int32))


@register_aggregator("trust")
def _trust(params: Dict[str, Any]):
    return WeightedAggregator(uniform=False)


@register_aggregator("fedavg")
def _fedavg(params: Dict[str, Any]):
    return WeightedAggregator(uniform=True)


# --------------------------------------------------------------------- #
# frequency controllers
# --------------------------------------------------------------------- #
class FixedController:
    """Benchmark scheme: constant a_i (still tolerance-bounded by Alg. 2).
    ``needs_ctx=False``: the engine reads nothing back to choose it."""

    needs_ctx = False

    def __init__(self, a: int = 5, n_actions: int = 10):
        self.a = int(a)
        self.n_actions = int(n_actions)

    def select(self, ctx: ControllerCtx) -> int:
        return self.a

    def observe(self, ctx, consumed, loss):
        pass

    def scan_policy(self) -> ctl_policy.ScanPolicy:
        return ctl_policy.fixed_policy(self.a)


class LyapunovGreedyController:
    """One-step drift-plus-penalty greedy controller (Eqns 12-15).

    Each slot scores every a in {1..n_actions} with the P2 objective
    v·ΔF̂(a) − Q(i)·(a·Ê_cmp + Ê_com), picks the first argmax, and advances
    its host copy of the deficit queue with the realized consumption.
    Scoring is `repro_torch.control.policy.lyapunov_scores` in float32, the
    function the device-side `scan_policy` uses too.
    """

    needs_ctx = True

    def __init__(self, budget: float = 250.0, horizon: int = 100,
                 kappa: float = 0.08, f_star: float = 0.1,
                 v0: float = 1.0, v_growth: float = 0.02,
                 n_actions: int = 10):
        self.queue = init_queue(budget, horizon)
        self.kappa = kappa
        self.f_star = f_star
        self.v0 = v0
        self.v_growth = v_growth
        self.n_actions = int(n_actions)

    def select(self, ctx: ControllerCtx) -> int:
        scores = ctl_policy.lyapunov_scores(
            self.queue.q, ctx.round, ctx.cluster_loss, ctx.mean_freq,
            ctx.channel_good_frac, n_actions=self.n_actions,
            kappa=self.kappa, f_star=self.f_star, v0=self.v0,
            v_growth=self.v_growth)
        return int(torch.argmax(scores)) + 1

    def observe(self, ctx, consumed, loss):
        self.queue = step_queue(self.queue, consumed)

    def scan_policy(self) -> ctl_policy.ScanPolicy:
        return ctl_policy.lyapunov_policy(
            n_actions=self.n_actions, kappa=self.kappa, f_star=self.f_star,
            v0=self.v0, v_growth=self.v_growth)

    def sync_queue(self, q) -> None:
        """Adopt the device-resident backlog after a scanned run."""
        self.queue = self.queue._replace(
            q=torch.as_tensor(q, dtype=torch.float32).cpu())


@register_controller("fixed")
def _fixed(params: Dict[str, Any]):
    return FixedController(a=params.get("a", 5),
                           n_actions=params.get("n_actions", 10))


@register_controller("lyapunov")
def _lyapunov(params: Dict[str, Any]):
    return LyapunovGreedyController(**params)


# --------------------------------------------------------------------- #
# task adapters
# --------------------------------------------------------------------- #
class MLPTask:
    """The paper's device-scale MNIST-shaped classifier on flat parameters.

    `init` fixes the flat layout (sorted keys: b1, b2, w1, w2); every other
    method takes (N,) or (M, N) flat tensors and reads the leaves through
    views.  `local_train` runs ``steps`` SGD steps of all M members at once:
    one batched forward, and one autograd gradient of the *sum* of the
    per-member mean losses, whose (M, N) rows are each member's own
    gradient because the members share no parameters.
    """

    def __init__(self, hidden: int = 200, n_classes: int = 10):
        self.hidden = hidden
        self.n_classes = n_classes
        self.layout = None

    def init(self, generator: torch.Generator, dim: int) -> torch.Tensor:
        params = init_mlp_classifier(generator, dim=dim, hidden=self.hidden,
                                     n_classes=self.n_classes)
        self.layout = layout_of(params)
        return flatten_rows({k: v[None] for k, v in params.items()})[0]

    def params(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return leaf_views(flat, self.layout)

    def local_train(self, flat, x, y, lr: float, steps: int):
        """(M, N) member parameters, (M, B, dim) / (M, B) batches -> the
        (M, N) parameters after ``steps`` SGD steps."""
        p = flat.contiguous()
        for _ in range(steps):
            p = p.detach().requires_grad_(True)
            loss = classifier_losses(self.params(p), x, y).sum()
            (g,) = torch.autograd.grad(loss, p)
            p = p - lr * g
        return p.detach()

    @torch.no_grad()
    def losses(self, flat, x, y):
        return classifier_losses(self.params(flat), x, y)

    @torch.no_grad()
    def evaluate(self, flat, data) -> Dict[str, float]:
        params = self.params(flat)
        return {
            "acc": float(accuracy(params, data.x, data.y)),
            "loss": float(classifier_losses(params, data.x[:1024],
                                            data.y[:1024])),
        }

    def corrupt_labels(self, y):
        """Byzantine label flip used by malicious members."""
        return (y + 1) % self.n_classes


@register_task("mlp")
def _mlp(params: Dict[str, Any]):
    return MLPTask(**{k: v for k, v in params.items()
                      if k in ("hidden", "n_classes")})
