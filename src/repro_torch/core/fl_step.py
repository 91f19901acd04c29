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

Sharding: ``_opt_specs_like``, `train_state_specs` and `batch_specs`
are the JAX package's specs of a (pod, data, model) mesh -- mode A puts
the (cluster, client) dims on (pod, data), mode B the cluster dim on pod
and the microbatch rows on data; tensor parallelism is on model
(`repro_torch.models.transformer.param_specs`).  `build_train_step` runs
on a state at those placements (DTensors,
`repro_torch.core.sharding.distribute_state`) as well as on a plain one,
with one body: each rank updates its own clients (mode A) or its rows of
each microbatch (mode B) on its shards of the model, Eqn 6 and Eqn 19
sum their partial products over the client and cluster axes, and every
client takes the global model back.  A plain state is that step over no
mesh (`repro_torch.core.sharding.NO_SHARDS`), every collective the
identity; at a mesh of one rank a group it is the same, op for op (the
module notes of `repro_torch.core.sharding`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from ..device import is_dtensor
from ..models.lm import lm_loss, weighted_lm_loss
from ..models.transformer import (LM, named_from_tree, param_specs,
                                  tree_from_named)
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


def client_divergence(params: Tree, shards=None, specs=None,
                      client_axes=()) -> torch.Tensor:
    """||w_i - w̄||_2 per client, the Eqn-4 learning-quality signal:
    leaves (NC, C, ...) -> (NC, C), reduced in slices of each leaf.

    In a sharded step (``shards``, the leaves' ``specs`` without their
    leading dims) the leaves are this rank's clients and shards: the
    client mean sums over ``client_axes``, and the squares of a leaf split
    over the step's compute axes sum over those."""
    from .sharding import NO_SHARDS, all_reduce_, spec_axes
    sh = shards or NO_SHARDS
    cg, tg = sh.group(client_axes), sh.group(sh.compute_axes)
    C = next(iter(params.values())).shape[1] * sh.size(client_axes)
    total = split = None
    for k, x in params.items():
        flat = x.reshape(x.shape[0], x.shape[1], -1)
        cut = tg is not None and any(a in sh.compute_axes
                                     for a in spec_axes(specs[k]))
        for s in range(0, flat.shape[-1], _CHUNK):
            xs = flat[..., s:s + _CHUNK]
            if cg is None:
                mean = xs.mean(dim=1, keepdim=True)
            else:
                mean = all_reduce_(xs.sum(dim=1, keepdim=True), cg) / C
            d = (xs - mean).to(torch.float32)
            part = (d * d).sum(dim=-1)
            if cut:
                split = part if split is None else split + part
            else:
                total = part if total is None else total + part
    if split is not None:
        all_reduce_(split, tg)
        total = split if total is None else total + split
    return torch.sqrt(total)


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


def _local_update(loss_fn: Callable, local_steps: int, params: Tree,
                  opt_state, batch: Tree, accum_dtype, sync: Callable,
                  update: Callable) -> torch.Tensor:
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
    pure, so each leaf's update is the one a whole-tree call would make.

    ``accum_dtype`` (the JAX package's; bfloat16 halves the gradient
    buffer of the 30B+ models) sums the microbatches' gradients in that
    dtype, each cast before it is added, and the averaged gradient stays
    in it.  ``sync(name, grad)`` sums the gradient over the ranks that
    hold the leaf whole (none unsharded), and ``update(name, grads, state,
    params)`` is the optimizer's update of the rank's shard."""
    n_micro = next(iter(batch.values())).shape[0]
    keys = list(params)
    key_set = set(keys)
    low = accum_dtype is not None and accum_dtype != params[keys[0]].dtype
    loss = None
    for _ in range(local_steps):
        leaves = {k: params[k].detach().requires_grad_() for k in keys}
        acc = ({k: torch.zeros(params[k].shape, dtype=accum_dtype,
                               device=params[k].device) for k in keys}
               if low else None)
        loss_sum = torch.zeros((), device=params[keys[0]].device)
        for i in range(n_micro):
            mb = {k: v[i] for k, v in batch.items()}
            mb_loss = loss_fn(leaves, mb)
            mb_loss.backward()
            loss_sum = loss_sum + mb_loss.detach()
            del mb_loss
            if low:
                for k in keys:
                    acc[k] = acc[k] + leaves[k].grad.to(accum_dtype)
                    leaves[k].grad = None
        with torch.no_grad():
            new = None
            for k in keys:
                if low:
                    g = acc.pop(k) / n_micro
                else:
                    g = leaves[k].grad.div_(n_micro)
                leaves[k].grad = None
                g = sync(k, g)
                updates, new = update(
                    k, {k: g}, _leaf_state(opt_state, key_set, k),
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
                     loss_fn: Optional[Callable] = None, accum_dtype=None,
                     ep: bool = False) -> Callable:
    """Returns train_step(state, batch, trust_rep, staleness) ->
    (state, metrics).

    Mode A shapes: params (NC,C,...); batch leaves (NC,C,n_micro,Bm,...);
                   trust_rep (NC,C); staleness (NC,).
    Mode B shapes: params (NC,...);   batch leaves (NC,n_micro,Bm,...) plus
                   batch["weights"] (NC,n_micro,Bm); trust_rep unused there.

    ``loss_fn(params, microbatch) -> scalar`` overrides the LM loss (the
    control plane is model-agnostic).  The state is updated in place.
    ``accum_dtype``: `_local_update`'s gradient buffer.

    A state whose leaves are DTensors (`sharding.distribute_state` at
    `train_state_specs`' placements) is stepped on this rank's shards
    (module notes), with the batch as DTensors at `batch_specs`'
    placements or whole on every rank, and ``trust_rep`` / ``staleness``
    whole on every rank; its metrics are whole on every rank, and its
    state stays at its placements.  A plain state is the same step over
    one rank (`sharding.NO_SHARDS`).  ``ep`` runs the MoE's
    expert-parallel branch (the JAX package's ``shard_map`` under
    ``set_mesh``).
    """
    model = LM(cfg, device="meta", seed=None)     # the structure, no weights
    lead = lead_dims(mode)

    def train_step(state: TrainState, batch, trust_rep, staleness):
        from . import sharding as shd
        rk = _rank_share(cfg, state, batch, mode, ep)
        sh, inner, compute = rk.shards, rk.inner, rk.compute
        if loss_fn is not None and sh.mesh is not None:
            raise ValueError("a sharded step computes the LM loss; a "
                             "custom loss_fn runs unsharded")
        axes = sh.compute_axes
        fed = rk.lead_axes[0] + (rk.lead_axes[1] if lead > 1 else ())
        fed_group = sh.group(fed)
        dev = rk.device
        trust_rep, staleness = trust_rep.to(dev), staleness.to(dev)

        def lm(leaves, mb):
            ps = {k: sh.relayout(v, inner[k], compute[k])
                  for k, v in leaves.items()}
            if mode == MODE_A:
                return lm_loss(model, mb, params=ps, remat=remat, shards=sh)
            return weighted_lm_loss(model, mb, mb["weights"], params=ps,
                                    remat=remat, shards=sh)

        def sync(k, g):
            return shd.all_reduce_(g, sh.group(shd.grad_axes(inner[k],
                                                             axes)))

        def update(k, grads, st, prm):
            return shd.sharded_update(opt, grads, st, prm, {k: inner[k]},
                                      sh.mesh, axes)

        def local_round(idx):
            at = tuple(o + i for o, i in zip(rk.origin, idx))
            ost = shd.map_tree(lambda t, w: t[at if w else idx], rk.opt,
                               rk.whole)
            loss = _local_update(loss_fn or lm, local_steps,
                                 _index(rk.params, idx), ost,
                                 _index(rk.batch, idx), accum_dtype, sync,
                                 update)
            return shd.all_reduce_(loss, sh.group(axes))

        def merge_whole_():
            """Each rank's clients' entries of the replicated leaves, to
            every rank."""
            def merge(t, w):
                if w and fed_group is not None:
                    mine = torch.zeros_like(t)
                    at = tuple(slice(o, o + n)
                               for o, n in zip(rk.origin, rk.n_local))
                    mine[at] = t[at]
                    t.copy_(shd.all_reduce_(mine, fed_group))
                return t
            shd.map_tree(merge, rk.opt, rk.whole)

        sw = staleness_weights(staleness)
        cluster_group = sh.group(rk.lead_axes[0])
        if mode == MODE_A:
            NC, C = trust_rep.shape
            (n0, c0), (NCl, Cl) = rk.origin, rk.n_local
            losses = torch.zeros((NC, C), device=dev)
            for n in range(NCl):
                for c in range(Cl):
                    losses[n0 + n, c0 + c] = local_round((n, c))
            shd.all_reduce_(losses, fed_group)
            merge_whole_()
            with torch.no_grad():
                div = torch.zeros((NC, C), device=dev)
                div[n0:n0 + NCl, c0:c0 + Cl] = client_divergence(
                    rk.params, sh, inner, rk.lead_axes[1])
                shd.all_reduce_(div, fed_group)
                w = normalize_weights(trust_rep)
                client_group = sh.group(rk.lead_axes[1])
                for x in rk.params.values():
                    # Eqn 6 over this rank's clients, summed over theirs
                    y = intra_cluster_agg(
                        {"x": x}, w[n0:n0 + NCl, c0:c0 + Cl])["x"]
                    shd.all_reduce_(y, client_group)
                    _aggregate_(x, y, sw[n0:n0 + NCl], cluster_group)
            metrics = {"loss": losses, "divergence": div,
                       "trust_weights": w}
        else:
            NC, (n0,), (NCl,) = staleness.shape[0], rk.origin, rk.n_local
            losses = torch.zeros((NC,), device=dev)
            for n in range(NCl):
                losses[n0 + n] = local_round((n,))
            shd.all_reduce_(losses, fed_group)
            merge_whole_()
            with torch.no_grad():
                for x in rk.params.values():
                    _aggregate_(x, x, sw[n0:n0 + NCl], cluster_group)
            metrics = {"loss": losses}
        return state._replace(round=state.round + 1), metrics

    return train_step


def _aggregate_(x: torch.Tensor, y: torch.Tensor, sw: torch.Tensor,
                group) -> None:
    """Eqn 19 of one leaf: this rank's clusters ``y`` (NCl, ...) weighted
    by their staleness weights ``sw``, summed over the cluster axis'
    ``group``, into every client (or cluster) of the leaf ``x``."""
    from .sharding import all_reduce_
    g = sw.to(y.dtype) @ y.reshape(y.shape[0], -1)
    all_reduce_(g, group)
    x.copy_(g.reshape(x.shape[x.dim() - y.dim() + 1:]).to(x.dtype)
            .expand_as(x))


class _RankShare(NamedTuple):
    """This rank's view of a step's state (`_rank_share`)."""
    shards: Any           # `sharding.Shards`; NO_SHARDS for a plain state
    inner: Dict[str, tuple]     # each leaf's at-rest spec, leading dims off
    compute: Dict[str, tuple]   # the layout each leaf is used in
    params: Tree          # the local tensors (the state's own storage)
    opt: Any
    whole: Any            # per optimizer leaf: whole over the federation
    batch: Tree           # this rank's rows of the batch
    origin: tuple         # this rank's first (cluster[, client])
    n_local: tuple        # its number of clusters[, clients]
    lead_axes: tuple      # the mesh axes of each leading dim
    device: torch.device


def _rank_share(cfg, state: TrainState, batch, mode: str, ep: bool
                ) -> _RankShare:
    """A placed state's local shards, specs and mesh coordinates; a plain
    state as the whole of it, over no mesh."""
    from . import sharding as shd
    lead = lead_dims(mode)
    first = next(iter(state.params.values()))
    if not is_dtensor(first):
        specs = {k: (None,) * (v.dim() - lead)
                 for k, v in state.params.items()}
        return _RankShare(
            shd.NO_SHARDS, specs, specs, state.params, state.opt,
            shd.map_tree(lambda t: False, state.opt), batch, (0,) * lead,
            tuple(first.shape[:lead]), ((),) * lead, first.device)
    mesh = first.device_mesh
    specs = {k: shd.spec_of(v) for k, v in state.params.items()}
    inner = {k: s[lead:] for k, s in specs.items()}
    compute = {k: shd.compute_spec(k, s) for k, s in inner.items()}
    sh = shd.Shards(mesh, compute, tokens=("data",) if mode == MODE_B
                    else (), ep=ep)
    lead_ax = tuple(shd.entry_axes(e) for e in specs[next(iter(specs))][
        :lead])
    # a leaf replicated over the federation's axes (the step count) holds
    # every client: it is indexed globally and merged after the round
    whole = shd.map_tree(lambda t: not any(shd.spec_of(t)[:lead]),
                         state.opt)
    bspecs = batch_specs(cfg, batch, mode=mode,
                         pod_axis=specs[next(iter(specs))][0])
    dev = first.to_local().device
    batch = {k: shd.local(v) if is_dtensor(v) else
             shd.local_chunk(v.to(dev), bspecs[k], mesh)
             for k, v in batch.items()}
    n_local = tuple(first.to_local().shape[:lead])
    origin = tuple(sh.index(a) * n for a, n in zip(lead_ax, n_local))
    return _RankShare(sh, inner, compute,
                      {k: shd.local(v) for k, v in state.params.items()},
                      shd.map_tree(shd.local, state.opt), whole, batch,
                      origin, n_local, lead_ax, dev)


# --------------------------------------------------------------------- #
# sharding specs (the JAX package's, as tuples) and the sharded step
# --------------------------------------------------------------------- #
def _has_leaf(tree) -> bool:
    """Whether a (nested) state holds any array (anything with a
    shape)."""
    if isinstance(tree, Mapping):
        return any(_has_leaf(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_leaf(v) for v in tree)
    return hasattr(tree, "shape")


def _opt_specs_like(opt_name: str, pspecs, opt_state_shapes):
    """Specs of the optimizer state, mirroring the parameters' (the step
    count is replicated: ``()``); the parameters as the port's names or
    as the JAX package's tree."""
    if opt_name in ("sgd",):                       # momentum tree or ()
        if not _has_leaf(opt_state_shapes):
            return opt_state_shapes
        return pspecs
    if opt_name in ("adam", "adamw"):
        return {"m": pspecs, "v": pspecs, "t": ()}
    if opt_name == "adafactor":
        def leaf_spec(ps, shapes):
            if isinstance(ps, tuple):          # a parameter's spec
                if "v" in shapes:
                    return {"v": ps}
                return {"r": ps[:-1], "c": ps[:-2] + ps[-1:]}
            if isinstance(ps, Mapping):
                return {k: leaf_spec(ps[k], shapes[k]) for k in ps}
            return [leaf_spec(p, s) for p, s in zip(ps, shapes)]
        return {"acc": leaf_spec(pspecs, opt_state_shapes["acc"]),
                "t": ()}
    raise ValueError(opt_name)


def train_state_specs(cfg, state_shapes: TrainState, *, mode: str,
                      opt_name: str, pod_axis=None, tp="model",
                      tp_size=16) -> TrainState:
    """The spec `TrainState` of ``state_shapes`` (any leaves with a
    ``shape``: meta tensors do): mode A stamps (pod_axis, 'data') on the
    (cluster, client) dims; mode B stamps pod_axis on the cluster dim and
    shards dense weights (``fsdp_tp``) or experts (``ep_tp``) over
    'data'."""
    if mode == MODE_A:
        leading = (pod_axis, "data")
        fsdp, stack_axis = None, None
    else:
        leading = (pod_axis,)
        fsdp = "data" if cfg.shard_scheme in ("ep_tp", "fsdp_tp") else None
        stack_axis = "data" if cfg.shard_scheme == "stack_tp" else None
    pspecs = param_specs(state_shapes.params, cfg, tp=tp, fsdp=fsdp,
                         stack_axis=stack_axis, leading=leading,
                         tp_size=tp_size)
    ospecs = _opt_specs_like(opt_name, pspecs, state_shapes.opt)
    return TrainState(pspecs, ospecs, ())


def batch_specs(cfg, batch_shapes, *, mode: str, pod_axis=None):
    """Token batches: the client dim over 'data' (mode A), the microbatch
    rows over 'data' (mode B)."""
    def spec(leaf):
        nd = len(tuple(leaf.shape))
        base = [None] * nd
        base[0] = pod_axis
        if mode == MODE_A:
            if nd >= 2:
                base[1] = "data"
        elif nd >= 3:
            base[2] = "data"       # (NC, n_micro, Bm, ...) -> Bm over data
        return tuple(base)
    return {k: spec(v) for k, v in batch_shapes.items()}


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
        meta = device is not None and torch.device(device).type == "meta"
        model = LM(cfg, device=device, seed=None if meta else seed)
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
