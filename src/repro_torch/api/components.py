"""Pluggable federation components of the port and their registry entries.

Aggregator        ``__call__(client_flat, weights, mask=None) -> (N,)``
                  over a (C, N) flat parameter matrix; ``supports_mask``
                  says it understands a (C,) validity mask, so the engine
                  runs it on padded fixed-shape clusters.
                  ``aggregate_with_global`` (the trust / fedavg rule)
                  folds the Eqn-19 global average into the same kernel
                  pass; the engine calls it once per round, except under
                  DP.  A rule without it (the robust rules) gives the
                  engine the Eqn-6 aggregate, and Eqn 19 runs as a second
                  step.
FrequencyController
                  ``select(ctx) -> int`` raw a_i before the Alg.-2 bound;
                  ``observe(ctx, consumed, loss)`` after the round;
                  ``n_actions`` caps a_i; ``needs_ctx`` False lets the
                  engine skip reading the context back from the card;
                  ``scan_policy()`` the device-side twin for `run_scanned`.
                  The registered factories take ``(params, device)``: the
                  DQN pretrains on the federation's device.
TaskAdapter       model plug over flat parameter vectors: init, batched
                  local training, per-member losses, evaluation, the
                  hidden-activation mean tau of the DQN observation.
                  The datacenter scale's `LMTask` instead names an
                  architecture and draws token batches.

Ported: the trust / fedavg aggregator, the robust rules (krum,
multi_krum, median, trimmed_mean), the fixed, Lyapunov and DQN
controllers, the MLP and autoencoder-anomaly tasks, and the LM task.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import rng
from repro_torch.control import policy as ctl_policy
from repro_torch.control.scanned_dqn import train_on_env
from repro_torch.core import dqn as dqn_lib
from repro_torch.core import envs
from repro_torch.core.autoencoder import (anomaly_auc, code_mean,
                                          init_mlp_autoencoder,
                                          reconstruction_errors,
                                          reconstruction_loss)
from repro_torch.core.fl_step import MODE_B
from repro_torch.core.lyapunov import init_queue, step_queue
from repro_torch.core.mlp import (accuracy, classifier_losses,
                                  init_mlp_classifier, mlp_hidden_mean)
from repro_torch.core.robust import AGGREGATORS as ROBUST_RULES
from repro_torch.core.robust import MASKED_AGGREGATORS as MASKED_RULES
from repro_torch.data.synthetic import token_stream
from repro_torch.device import is_dtensor, resolve_device
from repro_torch.kernels.ops import flatten_rows, layout_of, leaf_views
from repro_torch.kernels.trust_aggregate import (trust_aggregate,
                                                 trust_aggregate_global)

from .registry import (register_aggregator, register_controller,
                       register_task)


class ControllerCtx(NamedTuple):
    """What a host-side frequency controller may look at when choosing a_i."""
    round: int                       # global round counter
    cluster: int                     # cluster index being scheduled
    obs: Callable[[], torch.Tensor]  # lazy DQN observation (OBS_DIM,)
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


class RobustAggregator:
    """Byzantine-robust rules from `repro_torch.core.robust`; ignores the
    trust weights (that is their point: no reputation signal needed).
    Rules with a fixed-capacity masked variant (`median` /
    `trimmed_mean`) advertise ``supports_mask=True`` and join the padded
    round; krum and multi-krum run on exact-shape clusters, on the event
    heap only."""

    def __init__(self, rule: str, **kw):
        self.rule_name = rule
        self._rule = ROBUST_RULES[rule]
        self._masked_rule = MASKED_RULES.get(rule)
        self.supports_mask = self._masked_rule is not None
        self._kw = kw

    def __call__(self, client_flat, weights, mask=None):
        del weights
        if mask is not None:
            if self._masked_rule is None:
                raise ValueError(f"{self.rule_name} cannot run on padded "
                                 "clusters (supports_mask=False)")
            return self._masked_rule(client_flat, mask, **self._kw)
        return self._rule(client_flat, **self._kw)


@register_aggregator("trust")
def _trust(params: Dict[str, Any]):
    return WeightedAggregator(uniform=False)


@register_aggregator("fedavg")
def _fedavg(params: Dict[str, Any]):
    return WeightedAggregator(uniform=True)


def _register_robust(name):
    @register_aggregator(name)
    def _build(params: Dict[str, Any], _name=name):
        return RobustAggregator(_name, **{k: v for k, v in params.items()
                                          if k != "use_kernel"})


for _name in ROBUST_RULES:
    _register_robust(_name)


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


class DQNController:
    """Greedy policy of a trained Alg.-1 DQN agent.

    Build from a live agent (``DQNController(agent, cfg)``) or let the
    registry factory pretrain one on the DT-simulated environment, on the
    federation's device: the paper's headline mechanism, an agent that
    interacts with the twins, not the devices.
    """

    needs_ctx = True                    # select() reads the DQN observation

    def __init__(self, agent: dqn_lib.DQNState, cfg: dqn_lib.DQNConfig):
        self.agent = agent
        self.cfg = cfg
        self.n_actions = cfg.n_actions

    def select(self, ctx: ControllerCtx) -> int:
        q = dqn_lib.q_values(self.agent.eval_params, ctx.obs())
        return int(torch.argmax(q)) + 1     # the one host read of a select

    def observe(self, ctx, consumed, loss):
        pass

    def scan_policy(self) -> ctl_policy.ScanPolicy:
        return ctl_policy.dqn_policy(self.agent.eval_params)

    def distill(self, **kw) -> ctl_policy.PolicyTable:
        """Freeze the greedy head into a lookup table
        (`repro_torch.control.distill_table`)."""
        return ctl_policy.distill_table(self.agent.eval_params, **kw)

    def restore_policy_state(self, eval_params) -> None:
        """Adopt a checkpointed scan-policy carry (the deployed net)."""
        self.agent = self.agent._replace(eval_params=eval_params)

    @classmethod
    def pretrain(cls, seed: int = 0, episodes: int = 4, horizon: int = 25,
                 p_good: float = 0.5, calibrate_dt: bool = True,
                 buffer_size: int = 512, batch_size: int = 32,
                 lr: float = 2e-3, device=None) -> "DQNController":
        """Train a fresh agent on the DT environment (§IV-C, Alg. 1) on
        ``device`` (the card unless the caller asks for another), with the
        whole run on the device (`repro_torch.control.train_on_env`).
        ``pretrain_aux`` keeps the episodes' returns and lengths (None
        with ``episodes=0``: the agent as initialized)."""
        dev = resolve_device(device)
        p = envs.EnvParams(horizon=horizon, p_good=p_good,
                           calibrate_dt=calibrate_dt)
        cfg = dqn_lib.DQNConfig(buffer_size=buffer_size,
                                batch_size=batch_size, lr=lr)
        agent = dqn_lib.init_dqn(rng.generator(seed, rng.DQN_INIT), cfg,
                                 dev)
        aux = None
        if episodes:
            agent, aux = train_on_env(agent, cfg, p, episodes=episodes,
                                      seed=seed)
        ctl = cls(agent, cfg)
        ctl.pretrain_aux = aux
        return ctl


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
def _fixed(params: Dict[str, Any], device=None):
    return FixedController(a=params.get("a", 5),
                           n_actions=params.get("n_actions", 10))


@register_controller("dqn")
def _dqn(params: Dict[str, Any], device=None):
    agent = params.get("agent")
    if agent is not None:
        return DQNController(agent, params.get("dqn_cfg",
                                               dqn_lib.DQNConfig()))
    kw = {k: v for k, v in params.items() if k not in ("agent", "dqn_cfg")}
    return DQNController.pretrain(device=device, **kw)


@register_controller("lyapunov")
def _lyapunov(params: Dict[str, Any], device=None):
    return LyapunovGreedyController(**params)


# --------------------------------------------------------------------- #
# task adapters
# --------------------------------------------------------------------- #
class _FlatTask:
    """A task over flat parameter vectors: `init` fixes the sorted-key
    flat layout, every other method takes (N,) or (M, N) flat tensors and
    reads the leaves through views.  `local_train` runs ``steps`` SGD steps
    of all M members at once: one batched forward, and one gradient
    (`torch.func.grad`) of the *sum* of the per-member mean losses, whose
    (M, N) rows are each member's own gradient because the members share
    no parameters."""

    layout = None

    def _flat(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        self.layout = layout_of(params)
        return flatten_rows({k: v[None] for k, v in params.items()})[0]

    def params(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return leaf_views(flat, self.layout)

    def _losses(self, params, x, y):
        raise NotImplementedError

    def local_train(self, flat, x, y, lr, steps: int, a=None):
        """(M, N) member parameters, (M, B, dim) / (M, B) batches -> the
        (M, N) parameters after ``steps`` SGD steps.  ``lr`` is a float or
        a 0-d tensor.  With ``a`` (a 0-d integer tensor, at most
        ``steps``) the steps from the ``a``-th on leave the parameters as
        they were, so the result is exactly the ``a``-step one: a
        population runs its members' largest ``a`` and each member keeps
        its own (`torch.func.grad`, unlike ``torch.autograd.grad``, runs
        under ``torch.func.vmap``).

        Given DTensors (the partitioner-inferred placement), every rank
        trains the replicated members on its local tensors under
        ``local_map``, since ``torch.func.grad`` takes no DTensor; the
        result is replicated."""
        if is_dtensor(flat):
            from torch.distributed.tensor import Replicate
            from torch.distributed.tensor.experimental import local_map
            rep = tuple(Replicate() for _ in flat.placements)
            tensors = (flat, x, y) + ((a,) if torch.is_tensor(a) else ())
            args = [t if is_dtensor(t) else None for t in tensors]
            return local_map(
                lambda f, xx, yy, *aa: self._local_train(
                    f, xx, yy, lr, steps, aa[0] if aa else a),
                out_placements=(rep,),
                in_placements=tuple(None if t is None else rep
                                    for t in args),
                redistribute_inputs=True)(*tensors)
        return self._local_train(flat, x, y, lr, steps, a)

    def _local_train(self, flat, x, y, lr, steps: int, a=None):
        grad = torch.func.grad(
            lambda q: self._losses(self.params(q), x, y).sum())
        p = flat.contiguous()
        for k in range(steps):
            stepped = p - lr * grad(p)
            p = stepped if a is None else torch.where(k < a, stepped, p)
        return p

    @torch.no_grad()
    def losses(self, flat, x, y):
        return self._losses(self.params(flat), x, y)


class MLPTask(_FlatTask):
    """The paper's device-scale MNIST-shaped classifier (flat layout b1,
    b2, w1, w2)."""

    def __init__(self, hidden: int = 200, n_classes: int = 10):
        self.hidden = hidden
        self.n_classes = n_classes

    def init(self, generator: torch.Generator, dim: int) -> torch.Tensor:
        return self._flat(init_mlp_classifier(
            generator, dim=dim, hidden=self.hidden,
            n_classes=self.n_classes))

    def _losses(self, params, x, y):
        return classifier_losses(params, x, y)

    @torch.no_grad()
    def evaluate(self, flat, data) -> Dict[str, float]:
        params = self.params(flat)
        return {
            "acc": float(accuracy(params, data.x, data.y)),
            "loss": float(classifier_losses(params, data.x[:1024],
                                            data.y[:1024])),
        }

    @torch.no_grad()
    def hidden_mean(self, flat, x):
        return mlp_hidden_mean(self.params(flat), x)

    def corrupt_labels(self, y):
        """Byzantine label flip used by malicious members."""
        return (y + 1) % self.n_classes


class AutoencoderAnomalyTask(_FlatTask):
    """Federated autoencoder anomaly detection over IoT telemetry (flat
    layout b1..b4, w1..w4).

    The loss is the mean squared reconstruction error and training is
    unsupervised: the batch labels carry the anomaly ground truth for
    evaluation only, so the Eqn-4/5 trust pipeline runs on reconstruction
    gradients as it does on classification gradients.  ``evaluate``
    reports the reconstruction loss and the threshold-free detection AUC
    of per-sample errors against the labels (the trace's ``acc``).
    Label flipping has no lever here, so ``corrupt_labels`` is the
    identity.
    """

    def __init__(self, hidden: int = 64, code: int = 8):
        self.hidden = hidden
        self.code = code

    def init(self, generator: torch.Generator, dim: int) -> torch.Tensor:
        return self._flat(init_mlp_autoencoder(
            generator, dim=dim, hidden=self.hidden, code=self.code))

    def _losses(self, params, x, y):
        return reconstruction_loss(params, x)

    @torch.no_grad()
    def evaluate(self, flat, data) -> Dict[str, float]:
        scores = reconstruction_errors(self.params(flat), data.x)
        auc = float(anomaly_auc(scores, data.y))
        return {"acc": None if math.isnan(auc) else auc,   # detection AUC
                "loss": float(scores[:1024].mean())}

    @torch.no_grad()
    def hidden_mean(self, flat, x):
        return code_mean(self.params(flat), x)

    def corrupt_labels(self, y):
        return y          # unsupervised: labels never enter the loss


# the LMTask keywords that are not architecture dims
_LM_TASK_KEYS = ("mode", "seq", "micro_batch", "n_micro", "local_steps",
                 "lr")


def lm_task_config(arch: Optional[str] = None, **dims):
    """The `ArchConfig` an `LMTask` of these keywords trains: the smoke
    config of ``arch``, or a config of explicit dims over the JAX package's
    tiny defaults.  Task keywords that are not dims are ignored."""
    from repro_torch.models import ArchConfig
    if arch:
        from repro_torch.configs import get_smoke_config
        return get_smoke_config(arch)
    base = dict(name="api-tiny", arch_type="dense", num_layers=2,
                d_model=32, vocab_size=64, num_heads=2, num_kv_heads=1,
                d_ff=64)
    base.update({k: v for k, v in dims.items() if k not in _LM_TASK_KEYS})
    if isinstance(base.get("block_pattern"), list):     # from JSON
        base["block_pattern"] = tuple(base["block_pattern"])
    return ArchConfig(**base)


class LMTask:
    """Datacenter-scale LM task over the federated step's modes.

    ``arch`` names a smoke config of `repro_torch.configs`, or pass
    explicit dims (d_model/num_layers/...) for a self-contained config
    (the full width of an architecture, too).
    """

    def __init__(self, arch: Optional[str] = None,
                 mode: str = "fedavg_replica", seq: int = 16,
                 micro_batch: int = 2, n_micro: int = 1,
                 local_steps: int = 1, lr: float = 3e-4, **dims):
        self.cfg = lm_task_config(arch, **dims)
        self.mode = mode
        self.seq = seq
        self.micro_batch = micro_batch
        self.n_micro = n_micro
        self.local_steps = local_steps
        self.lr = lr

    def make_batch(self, generator: torch.Generator, n_clusters: int,
                   clients: int, device=None) -> Dict[str, torch.Tensor]:
        """Zipf token batches drawn from ``generator`` (on the CPU):
        tokens and labels (NC, C, n_micro, Bm, S) in mode A, (NC, n_micro,
        Bm, S) with per-example weights (NC, n_micro, Bm) in mode B; an
        audio model's K codebooks put (K, S) in place of S."""
        if self.mode == MODE_B:
            shape = (n_clusters, self.n_micro, self.micro_batch,
                     self.seq + 1)
        else:
            shape = (n_clusters, clients, self.n_micro, self.micro_batch,
                     self.seq + 1)
        if self.cfg.num_codebooks > 1:
            shape = shape[:-1] + (self.cfg.num_codebooks, self.seq + 1)
        toks = token_stream(generator, math.prod(shape),
                            self.cfg.vocab_size).reshape(shape).to(device)
        batch = {"tokens": toks[..., :-1].contiguous(),
                 "labels": toks[..., 1:].contiguous()}
        if self.mode == MODE_B:
            # trust enters as per-example loss weights in mode B
            batch["weights"] = torch.ones(
                (n_clusters, self.n_micro, self.micro_batch), device=device)
        return batch


@register_task("mlp")
def _mlp(params: Dict[str, Any]):
    return MLPTask(**{k: v for k, v in params.items()
                      if k in ("hidden", "n_classes")})


@register_task("autoencoder-anomaly")
def _autoencoder(params: Dict[str, Any]):
    # the data-generation params (n_samples, dim, n_types, ...) are read by
    # `engine.default_device_data`; only the model dims reach the task
    return AutoencoderAnomalyTask(**{k: v for k, v in params.items()
                                     if k in ("hidden", "code")})


@register_task("lm")
def _lm(params: Dict[str, Any]):
    return LMTask(**params)
