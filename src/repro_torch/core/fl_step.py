"""Federated train and serve steps of the language models (the JAX
package's ``core/fl_step.py``).

Two execution modes:

Mode A — ``fedavg_replica`` (the paper's FedAvg): every parameter leaf is
    one tensor with leading dims (NC, C) = (clusters, clients a cluster).
    Each client runs its local steps; Eqn 6 (the trust-weighted average
    over C) and Eqn 19 (the staleness-weighted average over NC) are then
    single reductions over those dims, and the global model goes back to
    every client.  Each client keeps its own optimizer state.

Mode B — ``trust_fsdp``: leaves carry a leading (NC,) cluster dim, and trust
    enters as per-example loss weights (``weighted_lm_loss``), which makes
    the gradient the trust-weighted aggregate (exact for a single FedSGD
    step); Eqn 19 then averages the clusters.

Every step: ``a`` local optimizer steps (the controller's aggregation
frequency), each averaging the gradients of ``n_micro`` microbatches; as
in the JAX package, the same batch serves every one of the ``a`` steps.

The JAX package ``vmap``s the local update over the clients; here the
clients run one after another on views into the stacked tensors, so one
client's activations are live at a time and the kernels need no batching
rule.  A step updates the state's tensors in place (the parameters, the
optimizer state) and returns the same `TrainState` with the round
advanced: at recurrentgemma-2b's width a copy of the four clients'
parameters and Adam moments would be another 44 GB.

The JAX package's ``_opt_specs_like``, ``train_state_specs`` and
``batch_specs`` are sharding specs of a device mesh; they come with the
multi-device port (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..models.lm import lm_loss, weighted_lm_loss
from ..models.transformer import LM, named_from_tree, tree_from_named
from ..optim import Optimizer
from .trust import staleness_weights

MODE_A = "fedavg_replica"
MODE_B = "trust_fsdp"

Tree = Dict[str, torch.Tensor]
_CHUNK = 1 << 24          # elements of a leaf reduced at once (divergence)


class TrainState(NamedTuple):
    params: Tree          # leaves (NC, C, ...) in mode A, (NC, ...) in B
    opt: Any              # optimizer state, stacked like the parameters
    round: int            # global round counter


def lead_dims(mode: str) -> int:
    """Leading (federation) dims of a leaf in ``mode``."""
    if mode == MODE_A:
        return 2
    if mode == MODE_B:
        return 1
    raise ValueError(mode)


# --------------------------------------------------------------------- #
# aggregation primitives
# --------------------------------------------------------------------- #
def normalize_weights(rep: torch.Tensor) -> torch.Tensor:
    """(NC, C) raw reputations -> per-cluster normalized trust weights."""
    rep = torch.clamp(rep, min=0.0)
    return rep / (rep.sum(dim=-1, keepdim=True) + 1e-8)


def intra_cluster_agg(params: Tree, w: torch.Tensor) -> Tree:
    """Eqn 6 over the client dim: leaves (NC, C, ...), w (NC, C) ->
    leaves (NC, ...), one batched product a leaf."""
    def agg(x):
        NC, C = x.shape[:2]
        y = torch.bmm(w.to(x.dtype)[:, None, :], x.reshape(NC, C, -1))
        return y.reshape((NC,) + x.shape[2:])
    return {k: agg(x) for k, x in params.items()}


def inter_cluster_agg(params: Tree, staleness: torch.Tensor) -> Tree:
    """Eqn 19 over the cluster dim: leaves (NC, ...), staleness (NC,) ->
    leaves (...), one product a leaf."""
    w = staleness_weights(staleness)

    def agg(x):
        return (w.to(x.dtype) @ x.reshape(x.shape[0], -1)
                ).reshape(x.shape[1:])
    return {k: agg(x) for k, x in params.items()}


def client_divergence(params: Tree) -> torch.Tensor:
    """||w_i - w̄||_2 per client, the Eqn-4 learning-quality signal:
    leaves (NC, C, ...) -> (NC, C), reduced in slices of each leaf."""
    total = None
    for x in params.values():
        flat = x.reshape(x.shape[0], x.shape[1], -1)
        for s in range(0, flat.shape[-1], _CHUNK):
            xs = flat[..., s:s + _CHUNK]
            d = (xs - xs.mean(dim=1, keepdim=True)).to(torch.float32)
            part = (d * d).sum(dim=-1)
            total = part if total is None else total + part
    return torch.sqrt(total)


def _broadcast_(params: Tree, glob: Tree) -> None:
    """Every client (or cluster) of ``params`` takes the global model."""
    with torch.no_grad():
        for k, x in params.items():
            x.copy_(glob[k].to(x.dtype).expand_as(x))


# --------------------------------------------------------------------- #
# local update (shared by both modes)
# --------------------------------------------------------------------- #
def _index(tree, idx):
    """Views of every tensor of a (nested) state at ``idx``."""
    if isinstance(tree, Mapping):
        return {k: _index(v, idx) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[idx]
    return tree


def _assign_(dst, src) -> None:
    """Copy a (nested) state into the views ``dst`` of a stacked one."""
    if isinstance(dst, Mapping):
        for k in dst:
            _assign_(dst[k], src[k])
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


def _leaf_state(state, keys, k: str):
    """The optimizer state as one leaf's update reads it: a dict keyed by
    the parameters (Adam's ``m``, ``v``; Adafactor's ``acc``) narrows to
    ``{k: ...}``; other entries (the step count ``t``) stay whole."""
    if isinstance(state, Mapping):
        if set(state) == keys:
            return {k: state[k]}
        return {n: _leaf_state(v, keys, k) for n, v in state.items()}
    return state


def _assign_part_(dst, src, keys, keyed: bool) -> None:
    """Copy into the views ``dst`` (a whole state) the entries of ``src``
    (a `_leaf_state`-shaped one) under the parameter-keyed dicts
    (``keyed``) or the others (the step count)."""
    if isinstance(src, Mapping):
        if isinstance(dst, Mapping) and set(dst) == keys:
            if keyed:
                _assign_({k: dst[k] for k in src}, src)
            return
        for n in src:
            _assign_part_(dst[n], src[n], keys, keyed)
    elif isinstance(src, torch.Tensor) and not keyed:
        dst.copy_(src)


def _local_update(loss_fn: Callable, opt: Optimizer, local_steps: int,
                  params: Tree, opt_state, batch: Tree) -> torch.Tensor:
    """``local_steps`` optimizer steps of one client, each averaging the
    gradients of the microbatches of ``batch`` (leaves (n_micro, Bm, ...)).
    ``params`` and ``opt_state`` are views into the stacked state and are
    updated in place.  -> the last step's mean microbatch loss.

    The microbatches' gradients add into the leaves' ``.grad`` as autograd
    reaches each leaf (microbatch 1's gradient, then + microbatch 2's: the
    JAX package's order), and the optimizer updates one leaf at a time, its
    new moments written into the state before the next leaf's are made.
    So one copy of the gradients is alive at a time and no full copy of
    the moments or updates: deepseek-v2's two full-width layers (7.8 GB of
    parameters a cluster) train in mode B on one card.  The optimizer is
    pure, so each leaf's update is the one a whole-tree call would make."""
    n_micro = next(iter(batch.values())).shape[0]
    keys = list(params)
    key_set = set(keys)
    loss = None
    for _ in range(local_steps):
        leaves = {k: params[k].detach().requires_grad_() for k in keys}
        loss_sum = torch.zeros((), device=params[keys[0]].device)
        for i in range(n_micro):
            mb = {k: v[i] for k, v in batch.items()}
            mb_loss = loss_fn(leaves, mb)
            mb_loss.backward()
            loss_sum = loss_sum + mb_loss.detach()
            del mb_loss
        with torch.no_grad():
            new = None
            for k in keys:
                g = leaves[k].grad.div_(n_micro)
                leaves[k].grad = None
                updates, new = opt.update(
                    {k: g}, _leaf_state(opt_state, key_set, k),
                    {k: params[k]})
                _assign_part_(opt_state, new, key_set, keyed=True)
                params[k].add_(updates[k].to(params[k].dtype))
                del g, updates
            # the entries every leaf shares (the step count), once
            _assign_part_(opt_state, new, key_set, keyed=False)
        del leaves, new
        loss = loss_sum / n_micro
    return loss


# --------------------------------------------------------------------- #
# step builders
# --------------------------------------------------------------------- #
def build_train_step(cfg, opt: Optimizer, *, mode: str, local_steps: int = 1,
                     remat: bool = True,
                     loss_fn: Optional[Callable] = None) -> Callable:
    """Returns train_step(state, batch, trust_rep, staleness) ->
    (state, metrics).

    Mode A shapes: params (NC,C,...); batch leaves (NC,C,n_micro,Bm,...);
                   trust_rep (NC,C); staleness (NC,).
    Mode B shapes: params (NC,...);   batch leaves (NC,n_micro,Bm,...) plus
                   batch["weights"] (NC,n_micro,Bm); trust_rep unused there.

    ``loss_fn(params, microbatch) -> scalar`` overrides the LM loss (the
    control plane is model-agnostic).  The state is updated in place.
    """
    model = LM(cfg, device="meta", seed=None)     # the structure, no weights
    if mode == MODE_A:
        if loss_fn is None:
            def loss_fn(params, mb):
                return lm_loss(model, mb, params=params, remat=remat)

        def train_step(state: TrainState, batch, trust_rep, staleness):
            NC, C = trust_rep.shape
            losses = torch.empty((NC, C), device=trust_rep.device)
            for n in range(NC):
                for c in range(C):
                    losses[n, c] = _local_update(
                        loss_fn, opt, local_steps,
                        _index(state.params, (n, c)),
                        _index(state.opt, (n, c)), _index(batch, (n, c)))
            with torch.no_grad():
                div = client_divergence(state.params)
                w = normalize_weights(trust_rep)
                glob = inter_cluster_agg(
                    intra_cluster_agg(state.params, w), staleness)
                _broadcast_(state.params, glob)
            metrics = {"loss": losses, "divergence": div,
                       "trust_weights": w}
            return state._replace(round=state.round + 1), metrics

        return train_step

    if mode == MODE_B:
        if loss_fn is None:
            def loss_fn(params, mb):
                return weighted_lm_loss(model, mb, mb["weights"],
                                        params=params, remat=remat)

        def train_step(state: TrainState, batch, trust_rep, staleness):
            NC = staleness.shape[0]
            losses = torch.empty((NC,), device=staleness.device)
            for n in range(NC):
                losses[n] = _local_update(
                    loss_fn, opt, local_steps, _index(state.params, n),
                    _index(state.opt, n), _index(batch, n))
            with torch.no_grad():
                _broadcast_(state.params,
                            inter_cluster_agg(state.params, staleness))
            return state._replace(round=state.round + 1), {"loss": losses}

        return train_step

    raise ValueError(mode)


def build_serve_step(model: LM) -> Callable:
    """serve_step(cache, tokens, step) -> (logits, cache): one decode step
    of ``model`` (plain decode; federated learning is train-time)."""
    def serve_step(cache, tokens, step: int):
        return model.decode_step(cache, tokens, step)
    return serve_step


# --------------------------------------------------------------------- #
# state construction and carry-over
# --------------------------------------------------------------------- #
def build_init_fn(cfg, opt: Optimizer, *, mode: str, n_clusters: int,
                  clients_per_cluster: int = 0, device=None) -> Callable:
    """init(seed) -> `TrainState`: the model drawn from ``seed`` on
    ``device``, copied to every client (mode A) or cluster (mode B), with
    one optimizer state each."""
    lead = ((n_clusters, clients_per_cluster) if mode == MODE_A
            else (n_clusters,))

    def init(seed: int = 0) -> TrainState:
        model = LM(cfg, device=device, seed=seed)
        params = {k: p.detach() for k, p in model.named_parameters()}
        opt_state = opt.init(params)
        stack = lambda x: x.expand(lead + tuple(x.shape)).clone()
        return TrainState({k: stack(p) for k, p in params.items()},
                          _map_tensors(opt_state, stack), 0)

    return init


def _map_tensors(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def _is_param_tree(tree) -> bool:
    return isinstance(tree, Mapping) and "embed" in tree


def train_state_from_numpy(state: Mapping[str, Any], cfg, *, mode: str,
                           device=None) -> TrainState:
    """A JAX ``TrainState`` as numpy arrays (``{"params", "opt",
    "round"}``: the parameter tree with its (NC, C) or (NC,) leading dims,
    and the optimizer state, e.g. Adam's ``{"m", "v", "t"}``) -> the
    port's `TrainState` on ``device``."""
    lead = lead_dims(mode)
    put = lambda a: torch.as_tensor(np.array(a), device=device)

    def convert(tree):
        if _is_param_tree(tree):
            return {k: put(v) for k, v in
                    named_from_tree(tree, cfg, lead).items()}
        if isinstance(tree, Mapping):
            return {k: convert(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)) and not tree:
            return ()
        return put(tree)

    return TrainState(convert(state["params"]), convert(state["opt"]),
                      int(np.asarray(state["round"])))


def train_state_to_numpy(state: TrainState, cfg, *, mode: str
                         ) -> Dict[str, Any]:
    """The inverse of `train_state_from_numpy`: parameter trees in the JAX
    package's layout, every leaf a numpy array."""
    lead = lead_dims(mode)

    def convert(tree):
        if _is_param_tree(tree):
            return tree_from_named(tree, cfg, lead)
        if isinstance(tree, Mapping):
            return {k: convert(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy()
        return tree

    return {"params": convert(state.params), "opt": convert(state.opt),
            "round": state.round}
