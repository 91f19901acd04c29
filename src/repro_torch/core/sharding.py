"""Sharded federated LM training: the JAX package's partition specs as
DTensor placements, and the collectives of a rank's share of the step.

A *spec* is a tuple with one entry a tensor dim: None (replicated), a mesh
axis name, or a tuple of names that shard the dim over several mesh axes,
major to minor (the counterpart of a ``PartitionSpec``;
`repro_torch.models.transformer.param_specs`,
`repro_torch.core.fl_step.train_state_specs` and ``batch_specs`` make
them).  On a `DeviceMesh` (`repro_torch.launch.mesh`) a spec becomes
DTensor placements (`placements`): ``Shard(d)`` on each mesh dim that
shards tensor dim d, ``Replicate()`` on the others.

At rest a sharded `TrainState` is DTensors at the specs' placements
(`distribute_state`; `full_state` undoes it).  The step
(`fl_step.build_train_step` on such a state) runs on the local tensors with
the collectives written out, rather than through DTensor's propagation:
`scripts/train_probe.py` lists aten ops of the step that the card's
DTensor has no strategy for, the kernels are opaque to it, and its
functional all-gather of CUDA tensors over gloo segfaults.  A rank's
share of the forward is a `Shards`:

  * tensor parallelism on ``model``: each rank holds its columns of the
    column-parallel weights (``wq``, ``wg``, ``in_proj``, the vocab of the
    embedding and head, ...) and its rows of the row-parallel ones, so the
    attention, RG-LRU and selective-scan kernels run on its own heads or
    channels; a block's partial outputs meet in one all-reduce
    (`Shards.reduce`).  Where the heads do not split whole (a K/V head
    count the axis does not divide), the projections are gathered to
    whole heads before the kernel and cut back after it;
  * in mode B the tokens split over ``data``: FSDP'd weights
    (``fsdp_tp``) rest sharded over ``data`` and are gathered a layer at a
    time, as the layer runs (`Shards.use` with the at-rest specs ``rest``,
    inside the layer's checkpoint: its recompute gathers again), and the
    MoE gathers its tokens (the plain dispatch the JAX package's plan
    runs) or exchanges them all-to-all (the expert-parallel branch,
    ``ep=True``);
  * the loss of each rank is its *share*: the shares of all ranks of the
    step's group sum to the loss.  Every collective's backward is its
    adjoint (an all-reduce's is an all-reduce, an all-gather's a
    reduce-scatter, an all-to-all's the reverse one), so every rank's
    gradient is the derivative of the summed loss with respect to its own
    tensors: a leaf sharded over an axis needs nothing more, a leaf
    replicated over it has its gradient summed over it (`grad_axes`).

The optimizer updates a rank's shard of each leaf; Adafactor's factored
moments average over dims that may be sharded, so a sharded leaf's
update runs on the whole leaf, gathered, and each rank keeps its chunk
(`sharded_update`): the unsharded values.  The unsharded step is the same code on
`NO_SHARDS`, a share with no mesh: every group is None and every
collective, chunk and relayout the identity; on a mesh whose groups are
all of one rank the same holds, so the step is the unsharded one, op for
op.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import is_dtensor

Spec = Tuple[Any, ...]


# --------------------------------------------------------------------- #
# specs and placements
# --------------------------------------------------------------------- #
def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names."""
    return tuple(a for e in spec for a in entry_axes(e))


def _names(mesh) -> Tuple[str, ...]:
    return () if mesh is None else tuple(mesh.mesh_dim_names or ())


def _check(spec: Spec, mesh) -> None:
    names = _names(mesh)
    seen = spec_axes(spec)
    for a in seen:
        if a not in names:
            raise ValueError(f"spec {spec} names axis {a!r}, which the mesh "
                             f"{names} does not have")
    if len(set(seen)) != len(seen):
        raise ValueError(f"spec {spec} names an axis twice")
    for e in spec:
        ax = entry_axes(e)
        if list(ax) != sorted(ax, key=names.index):
            raise ValueError(f"spec entry {e}: axes must go major to minor "
                             f"in the mesh's order {names}")


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that shards tensor dim d, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    _check(spec, mesh)
    names = _names(mesh)
    out = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        for a in entry_axes(e):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def spec_of(t) -> Spec:
    """The spec of a DTensor's placements (an entry a tensor dim; several
    mesh dims on one tensor dim give a tuple, in the mesh's order)."""
    names = _names(t.device_mesh)
    axes = [[] for _ in range(t.dim())]
    for i, p in enumerate(t.placements):
        if p.is_shard():
            axes[p.dim].append(names[i])
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)


def _coord(mesh, name: str) -> int:
    return mesh.get_local_rank(_names(mesh).index(name))


def _size(mesh, name: str) -> int:
    return mesh.size(_names(mesh).index(name))


def local_chunk(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` under ``spec`` (a view;
    each sharded dim must divide, as the JAX package requires)."""
    _check(spec, mesh)
    for d, e in enumerate(spec):
        for a in entry_axes(e):
            n = _size(mesh, a)
            if t.shape[d] % n:
                raise ValueError(
                    f"dim {d} of a {tuple(t.shape)} tensor does not divide "
                    f"over the {n} ranks of mesh axis {a!r} (spec {spec})")
            m = t.shape[d] // n
            t = t.narrow(d, _coord(mesh, a) * m, m)
    return t


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def distribute(t: torch.Tensor, spec: Spec, mesh):
    """The DTensor of the whole tensor ``t`` (the same on every rank) at
    ``spec``'s placements: this rank keeps its shard (a copy of its own,
    so that ``t`` can be freed), nothing travels."""
    from torch.distributed.tensor import DTensor
    t = torch.as_tensor(t).to(_mesh_device(mesh))
    mine = local_chunk(t, spec, mesh)
    if mine.numel() < t.numel():
        mine = mine.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(mine.contiguous(), mesh,
                              placements(spec, mesh), run_check=False)


def full(t):
    """The whole value of a DTensor on every rank, gathered by the
    process groups' all-gathers (a collective where it is sharded: every
    rank calls it; gloo's all-gather of a CUDA tensor through DTensor's
    functional collectives segfaults on the card's torch); anything else
    as it is."""
    if not is_dtensor(t):
        return t
    with torch.no_grad():
        return Shards(t.device_mesh, {}).relayout(
            t.to_local(), spec_of(t), (None,) * t.dim())


def local(t):
    """A DTensor's local shard (sharing its storage); anything else as it
    is."""
    return t.to_local() if is_dtensor(t) else t


def map_tree(fn, tree, *rest):
    """``fn`` over the tensors of a (nested) dict or list (a decode
    cache), with the matching leaves of the trees ``rest`` (specs) beside
    each; anything else is kept."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    return tree


def distribute_state(state, specs, mesh):
    """A whole `TrainState` (the same on every rank) -> its DTensors at
    the specs' placements (`fl_step.train_state_specs`)."""
    put = lambda t, s: distribute(t, s, mesh)
    return type(state)(map_tree(put, state.params, specs.params),
                       map_tree(put, state.opt, specs.opt), state.round)


def full_state(state):
    """A sharded `TrainState` as whole plain tensors on every rank (one
    all-gather a sharded leaf: every rank calls it)."""
    return type(state)(map_tree(full, state.params),
                       map_tree(full, state.opt), state.round)


def distribute_tree(tree, specs, mesh):
    """A whole tree of tensors (parameters, a decode cache: the same on
    every rank) -> its DTensors at the specs' placements."""
    return map_tree(lambda t, s: distribute(t, s, mesh), tree, specs)


def full_tree(tree):
    """A tree of DTensors as whole plain tensors on every rank (one
    all-gather a sharded leaf: every rank calls it)."""
    return map_tree(full, tree)


def from_local(t: torch.Tensor, spec: Spec, mesh):
    """The DTensor whose shard on this rank is ``t`` (sharing its storage)
    at ``spec``'s placements: nothing travels."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, mesh, placements(spec, mesh),
                              run_check=False)


def distribute_batch(batch, specs, mesh):
    """A whole batch (the same on every rank) -> DTensors at
    `fl_step.batch_specs`' placements."""
    return {k: distribute(v, specs[k], mesh) for k, v in batch.items()}


# --------------------------------------------------------------------- #
# process groups of mesh axes
# --------------------------------------------------------------------- #
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Any] = {}


def axis_group(mesh, axes: Sequence[str]):
    """The process group of this rank's slice of ``mesh`` over ``axes``
    (ranks in row-major order of the axes: major to minor), or None when
    the slice is one rank.  Every rank must ask for a multi-axis group
    the first time together: it is made with ``new_group`` once a slice."""
    names = _names(mesh)
    axes = tuple(a for a in names if a in axes)
    if math.prod(_size(mesh, a) for a in axes) == 1:
        return None                        # no mesh, or a one-rank slice
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(_size(mesh, a) for a in axes))
        me, mine = dist.get_rank(), None
        for row in ranks.tolist():
            g = dist.new_group(row)
            if me in row:
                mine = g
        _GROUPS[key] = (mesh, mine)      # the mesh kept alive with its id
    return _GROUPS[key][1]


# --------------------------------------------------------------------- #
# collectives whose backward is their adjoint
# --------------------------------------------------------------------- #
collectives: Dict[str, Dict[str, int]] = {}


# context-manager factories entered around the gathers of `Shards.use`
# (`repro_torch.launch.op_stats.OpStats` counts what is made inside as
# gathered parameters)
gather_scopes: List[Callable[[], Any]] = []


def reset_collectives() -> None:
    """Set the counts of the step's own collectives to 0."""
    collectives.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    """One collective of ``kind`` on this rank's input ``t`` (forward or
    backward): the counts a round reads (`collectives`)."""
    c = collectives.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def _all_reduce(x, group, op=None):
    _count("all_reduce", x)
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    return x


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def _gather(x, dim, group, n):
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=xt.dtype, device=xt.device)
    _count("all_gather", xt)
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(g, dim, group, n):
    gt = g.movedim(dim, 0).contiguous()
    out = torch.empty((gt.shape[0] // n,) + tuple(gt.shape[1:]),
                      dtype=gt.dtype, device=gt.device)
    _count("reduce_scatter", gt)
    dist.reduce_scatter_tensor(out, gt, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.n), None, None, None


def _all_to_all(x, split_dim, cat_dim, group, n):
    send = torch.stack(x.chunk(n, split_dim), 0).contiguous()
    recv = torch.empty_like(send)
    _count("all_to_all", send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), cat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group, n):
        ctx.args = (cat_dim, split_dim, group, n)
        return _all_to_all(x, split_dim, cat_dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, *ctx.args), None, None, None, None)


def all_reduce_(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """In-place all-reduce of a tensor outside autograd (no-op without a
    group)."""
    return x if group is None else _all_reduce(x, group, op)


# --------------------------------------------------------------------- #
# a rank's share of the forward
# --------------------------------------------------------------------- #
class Shards:
    """A rank's share of a sharded forward (module notes): the mesh, the
    compute spec of every parameter (its spec without the federation's
    leading dims and with the FSDP'd ``data`` entries gathered) and, where
    the parameters are handed over as they rest, their at-rest specs
    (``rest``: `use` gathers a layer's), the axes the tokens split over (``tokens``: ``('data',)`` in mode B), and
    whether the MoE runs its expert-parallel branch (``ep``); tensor
    parallelism is on ``model`` (``tp``).  The model's blocks take the view of
    their own parameters (`sub`); every collective is skipped over a
    group of one rank.  ``mesh`` None (`NO_SHARDS`): the unsharded
    forward, every parameter whole."""

    def __init__(self, mesh, specs: Mapping[str, Spec], *,
                 tokens: Tuple[str, ...] = (), ep: bool = False,
                 prefix: str = "", rest: Mapping[str, Spec] = None):
        self.mesh, self.specs = mesh, specs
        names = _names(mesh)
        self.tp = ("model",) if "model" in names else ()
        self.tokens = tuple(a for a in tokens if a in names)
        self.ep, self.prefix, self.rest = ep, prefix, rest

    def sub(self, prefix: str) -> "Shards":
        return Shards(self.mesh, self.specs, tokens=self.tokens, ep=self.ep,
                      prefix=f"{self.prefix}{prefix}.", rest=self.rest)

    def use(self, params: Mapping[str, torch.Tensor], prefix: str = ""
            ) -> Dict[str, torch.Tensor]:
        """``params`` (this rank's shards at their at-rest specs ``rest``,
        named under ``prefix``) in their compute layouts: the FSDP'd
        leaves gathered (serving and training gather a layer's as it
        runs).  Without
        ``rest`` the parameters are in their compute layouts already."""
        if not self.rest:
            return dict(params)
        pre = f"{self.prefix}{prefix}." if prefix else self.prefix
        with contextlib.ExitStack() as scopes:
            for scope in gather_scopes:
                scopes.enter_context(scope())
            return {k: self.relayout(v, self.rest[pre + k],
                                     self.specs[pre + k])
                    for k, v in params.items()}

    def spec(self, name: str) -> Spec:
        return self.specs[self.prefix + name]

    def axes(self, name: str, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split dim ``dim`` of parameter ``name``."""
        return () if self.mesh is None else entry_axes(self.spec(name)[dim])

    @property
    def compute_axes(self) -> Tuple[str, ...]:
        """Every axis the step's work splits over."""
        names = _names(self.mesh)
        return tuple(a for a in names if a in self.tp + self.tokens)

    def size(self, axes: Sequence[str]) -> int:
        return math.prod(_size(self.mesh, a) for a in axes
                         if a in _names(self.mesh))

    def index(self, axes: Sequence[str]) -> int:
        """This rank's position in the slice over ``axes``, major to
        minor."""
        i = 0
        for a in axes:
            if a in _names(self.mesh):
                i = i * _size(self.mesh, a) + _coord(self.mesh, a)
        return i

    def group(self, axes: Sequence[str]):
        return axis_group(self.mesh, axes)

    # -- collectives (identity over one rank) ------------------------- #
    def reduce(self, x, axes: Sequence[str]):
        """Sum of every rank's ``x`` over ``axes``."""
        g = self.group(axes)
        return x if g is None else _AllReduce.apply(x, g)

    def gather(self, x, dim: int, axes: Sequence[str]):
        """The ranks' ``x`` concatenated along ``dim`` in rank order over
        ``axes``."""
        g = self.group(axes)
        return x if g is None else _AllGather.apply(
            x, dim % x.dim(), g, self.size(axes))

    def chunk(self, x, dim: int, axes: Sequence[str]):
        """This rank's chunk of ``x`` along ``dim`` over ``axes`` (a view;
        its backward puts the gradient back in place)."""
        n = self.size(axes)
        if n == 1:
            return x
        m = x.shape[dim] // n
        return x.narrow(dim, self.index(axes) * m, m)

    def all_to_all(self, x, split_dim: int, cat_dim: int,
                   axes: Sequence[str]):
        """Chunk j of ``x`` along ``split_dim`` to rank j over ``axes``;
        the chunks received concatenated along ``cat_dim``."""
        g = self.group(axes)
        return x if g is None else _AllToAll.apply(
            x, split_dim, cat_dim, g, self.size(axes))

    def relayout(self, x, src: Spec, dst: Spec):
        """``x`` (this rank's shard under ``src``) as its shard under
        ``dst``: every dim whose axes differ is gathered first (the ranks
        of a gather hold the same slice of the other dims only before any
        is cut), then cut."""
        moved = [d for d, (s, t) in enumerate(zip(src, dst))
                 if entry_axes(s) != entry_axes(t)]
        for d in moved:
            x = self.gather(x, d, entry_axes(src[d]))
        for d in moved:
            x = self.chunk(x, d, entry_axes(dst[d]))
        return x


NO_SHARDS = Shards(None, {})     # the unsharded forward


# --------------------------------------------------------------------- #
# the step's pieces
# --------------------------------------------------------------------- #
_EXPERT = ("wg", "wu", "wd")


def compute_spec(name: str, spec: Spec, data: str = "data") -> Spec:
    """The layout a parameter is used in: its at-rest spec (leading dims
    dropped) with the FSDP'd ``data`` entries gathered.  Kept on
    ``data``: a dim split jointly with ``model`` (the MoE d_ff of
    ``ep_tp`` when the experts do not divide) and the expert dim of
    expert-parallel weights."""
    parts = name.split(".")
    expert = "moe" in parts and "shared" not in parts and \
        parts[-1] in _EXPERT

    def keep(d, e):
        if e != data:
            return e
        return e if (expert and d == 0) else None
    return tuple(keep(d, e) for d, e in enumerate(spec))


def grad_axes(spec: Spec, compute_axes: Sequence[str]) -> Tuple[str, ...]:
    """The compute axes a leaf's gradient is summed over: those its
    at-rest spec does not shard it on."""
    named = spec_axes(spec)
    return tuple(a for a in compute_axes if a not in named)


def _reduces(state) -> bool:
    """Whether an optimizer state's update averages over a leaf's dims
    (Adafactor's factored moments and update clipping)."""
    return isinstance(state, Mapping) and "acc" in state


def state_spec(state, spec):
    """The spec tree of one unit's optimizer state (`fl_step._leaf_state`'s
    shape) from its leaves' specs (``spec``: one leaf's, or a dict of
    them by name): `fl_step._opt_specs_like` per leaf."""
    if isinstance(state, Mapping):
        if isinstance(spec, Mapping) and set(state) == set(spec):
            return {k: state_spec(v, spec[k]) for k, v in state.items()}
        out = {}
        for n, v in state.items():
            if n in ("r", "c", "v") and isinstance(v, torch.Tensor):
                # a 1-D leaf of a stacked group keeps its group's column
                out[n] = (spec[:-1] if n == "r" else
                          spec if n == "v" or v.dim() == len(spec) else
                          spec[:-2] + spec[-1:])
            elif n == "t":
                out[n] = ()
            else:
                out[n] = state_spec(v, spec)
        return out
    if isinstance(state, torch.Tensor):
        return spec if state.dim() == len(spec) else ()
    return state


def _sharded(specs, mesh, axes) -> bool:
    return any(a in axes and _size(mesh, a) > 1
               for spec in specs.values() for a in spec_axes(spec))


def sharded_update(opt, grads, state, params, specs: Mapping[str, Spec],
                   mesh, axes: Sequence[str], groups=()):
    """``opt.update`` of one unit's shards: a leaf, or a stacked group of
    1-D leaves (``groups``; a group of >= 2-D leaves goes a leaf at a time
    through `sharded_unclipped`).  Elementwise optimizers (SGD, Adam)
    update the local shards as they are.  An update that averages over
    the leaves' dims (Adafactor's factored moments and its update
    clipping) of leaves sharded over ``axes`` runs on the whole leaves'
    gradients and state, gathered on every rank by the process groups'
    all-gathers (such an update reads no parameters: Adafactor's), and
    each rank keeps its chunk of the updates and of the new state: the
    unsharded update of the same gradients, bit for bit, and no DTensor
    collective.  The gathered tensors are made contiguous, as the
    unsharded step's are: a reduction over a strided layout sums in
    another order on the CPU.  ``specs``: the leaves' at-rest specs
    without the leading dims."""
    if not (_sharded(specs, mesh, axes) and _reduces(state)):
        return opt.update(grads, state, params, groups=groups)
    sh = Shards(mesh, {})
    up = lambda t, s: sh.relayout(                               # noqa
        t, s, (None,) * len(s)).contiguous()
    down = lambda t, s: sh.relayout(t, (None,) * len(s), s)     # noqa
    updates, new = opt.update({k: up(grads[k], specs[k]) for k in grads},
                              map_tree(up, state, state_spec(state, specs)),
                              groups=groups)
    return ({k: down(u, specs[k]) for k, u in updates.items()},
            map_tree(down, new, state_spec(new, specs)))


def sharded_unclipped(opt, k: str, grad, state, spec: Spec, mesh,
                      axes: Sequence[str]):
    """``opt.unclipped`` of the leaf ``k``'s shard (a leaf of a stacked
    group of >= 2-D leaves, `fl_step._local_update`): a leaf sharded over
    ``axes`` is gathered whole with its state, as in `sharded_update`, and
    freed on return -> (this rank's chunk of the unclipped update and of
    the new state, the whole leaf's float32 sum of squares of the update,
    and its number of entries).  The update's chunk is a copy: the caller
    holds every leaf's of a group until it clips them, and a view would
    keep each whole update alive with it."""
    if not _sharded({k: spec}, mesh, axes):
        us, new, ss = opt.unclipped({k: grad}, state)
        return us[k], new, ss, us[k].numel()
    sh = Shards(mesh, {})
    specs = {k: spec}
    whole = (None,) * len(spec)
    us, new, ss = opt.unclipped(
        {k: sh.relayout(grad, spec, whole).contiguous()},
        map_tree(lambda t, s: sh.relayout(t, s, (None,) * len(s))
                 .contiguous(), state, state_spec(state, specs)))
    down = lambda t, s: sh.relayout(t, (None,) * len(s), s)     # noqa
    return (down(us[k], spec).clone(memory_format=torch.contiguous_format),
            map_tree(down, new, state_spec(new, specs)), ss, us[k].numel())
