"""Per-rank op statistics of an eager step: the counterpart of the JAX
package's ``launch/hlo_stats.py`` (``analyze_module``, ``traffic_breakdown``,
``loop_summary``, ``op_histogram``).

The JAX package reads its numbers from the compiled SPMD module's HLO text.
The port has no such module: its step runs eagerly, every layer and
microbatch in turn, so `OpStats` counts them as they dispatch -- on meta
tensors (a plan traced on a fake mesh, nothing allocated) or on real ones
-- and needs no trip counts.  It is a ``TorchDispatchMode`` that steps
aside for DTensor (the ops a DTensor lowers to come back to it as plain
ones, collectives included), as ``torch.distributed._tools``' trackers do.
Per rank it gives:

- ``flops``: matrix products as ``torch.utils.flop_counter`` counts them,
  plus each hand-written kernel's operations as its wrapper reports them
  (`repro_torch.kernels.launch.kernel_work`: the reachable pairs of a
  causal or windowed attention, not a dense score matrix);
- ``traffic``: a device-memory traffic proxy, the input plus output bytes
  of each op that is not a view or an allocation, by op kind (a kernel's
  kind is ``kernel:<name>``, its bytes the wrapper's);
- ``collectives``: calls and result bytes by kind (process-group and
  functional collectives alike), and with ``record=True`` their order;
- ``peak``: the live storages' bytes at their peak, split into the
  categories the caller registers (`track`: parameters, optimizer state,
  inputs, a cache), ``gradients`` (the ``.grad`` of a leaf made by
  ``detach``, as the training step makes its parameters' leaves) and
  ``other`` (activations and temporaries), as
  ``torch.distributed._tools.mem_tracker.MemTracker`` splits them; a CUDA
  storage counts in the allocator's 512-byte blocks.  Under any dispatch
  mode a tensor counts as subclass-like, and autograd then takes the
  out-of-place form of what it otherwise does in place.  Two such ops are
  known, both measured on a card against ``max_memory_allocated``: the
  sum of a tensor's two gradients (``add`` for ``add_``) and
  ``gather``'s backward (``scatter_add`` into fresh zeros for
  ``scatter_add_``): `_IN_PLACE`.  Such an op in the backward whose first
  input (of its shape and type) dies before the next op counts as done
  in that input's buffer, as the program run without the counter holds
  it.  Every other op counts out of place, so where autograd swaps some
  other op the peak errs high;
- ``op_hist``: calls by op;
- ``layers``: traffic by the model layer the op ran in
  (``torch.distributed._tools.mod_tracker.ModTracker``: forward,
  recompute and backward; decode calls no module and counts as
  ``other``), the counterpart of ``loop_summary``.

Inside a kernel wrapper's call only its report counts: the plain version
that stands in for the kernel on the CPU adds no operations, traffic or
temporaries, and the storages that leave the call are its outputs.
"""
from __future__ import annotations

import contextlib
import re
import weakref
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import launch as klaunch

CATEGORIES = ("parameters", "gradients", "optimizer", "inputs", "cache",
              "other")

_c10d = torch.ops.c10d
_fc = torch.ops._c10d_functional
# collective op -> (kind, where its result is: the argument index, or
# "out" for the functional ops' returned tensor)
_COLLECTIVES = {
    _c10d.allreduce_.default: ("all_reduce", 0),
    _c10d.allgather_.default: ("all_gather", 0),
    _c10d._allgather_base_.default: ("all_gather", 0),
    _c10d.allgather_into_tensor_coalesced_.default: ("all_gather", 0),
    _c10d.reduce_scatter_.default: ("reduce_scatter", 0),
    _c10d._reduce_scatter_base_.default: ("reduce_scatter", 0),
    _c10d.reduce_scatter_tensor_coalesced_.default: ("reduce_scatter", 0),
    _c10d.alltoall_.default: ("all_to_all", 0),
    _c10d.alltoall_base_.default: ("all_to_all", 0),
    _c10d.broadcast_.default: ("broadcast", 0),
    _fc.all_reduce.default: ("all_reduce", "out"),
    _fc.all_reduce_.default: ("all_reduce", "out"),
    _fc.all_gather_into_tensor.default: ("all_gather", "out"),
    _fc.reduce_scatter_tensor.default: ("reduce_scatter", "out"),
    _fc.all_to_all_single.default: ("all_to_all", "out"),
    _fc.broadcast.default: ("broadcast", "out"),
}
# ops that move no bytes of their own: allocations and metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias",
         "_local_scalar_dense", "wait_tensor", "set_", "resize_"}
_LAYER = re.compile(r"(?:^|\.)layers\.(\d+)(?:\.|$)")
# the ops autograd runs out of place under a dispatch mode where it runs
# their in-place forms without one (module notes)
_IN_PLACE = {"add", "scatter_add"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(args) -> Tuple[int, ...]:
    """The global ranks of a collective's group: its process group (a c10d
    op's argument; the reduction's op is another script object) or its
    group's name (a functional op's last string argument)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return tuple(dist.get_process_group_ranks(
                    dist.ProcessGroup.unbox(a)))
            except RuntimeError:        # not a process group
                continue
    names = [a for a in args if isinstance(a, str)]
    if names:
        return tuple(dist.get_process_group_ranks(
            _resolve_process_group(names[-1])))
    return ()


class _Storage:
    __slots__ = ("nbytes", "category", "ref")


class OpStats(TorchDispatchMode):
    """Counts a step's operations, traffic, collectives and live storages
    on this rank (module notes).  ``record``: keep each collective's
    (kind, group ranks, shape, dtype) in order (`sequence`)."""

    def __init__(self, *, record: bool = False):
        super().__init__()
        self.record = record
        self.matmul_flops = 0
        self.kernel_flops: Counter = Counter()
        self.kernel_calls: Counter = Counter()
        self.traffic: Counter = Counter()
        self.layers: Counter = Counter()
        self.op_hist: Counter = Counter()
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.collective_groups: Counter = Counter()   # ranks -> bytes
        self.sequence: List[Tuple[str, Tuple[int, ...], Tuple[int, ...],
                                  str]] = []
        self.live: Counter = Counter()
        self.peak_bytes = 0
        self.peak: Dict[str, int] = {}
        self._storages: Dict[int, _Storage] = {}
        self._leaves: List[weakref.ref] = []
        self._kernel_depth = 0
        self._pending: List[torch.UntypedStorage] = []
        self._deferred: Optional[_Storage] = None
        self._mods = None
        self._models: List[torch.nn.Module] = []

    # -- registration ---------------------------------------------------- #
    def name_modules(self, model: torch.nn.Module) -> None:
        """Name ``model``'s submodules by their paths in it (``layers.3``)
        for the layers' traffic: a step calls the layers themselves, not
        the model, and ``ModTracker`` would name each by its class."""
        self._models.append(model)

    def track(self, category: str, tree) -> None:
        """Count the storages of the tensors of ``tree`` (DTensors: their
        local shards) as live, in ``category``."""
        for t in _tensors(tree):
            self._add(_local(t).untyped_storage(), category)

    def _add(self, st: torch.UntypedStorage, category: str) -> None:
        key = id(st)
        have = self._storages.get(key)
        if have is not None and have.ref() is st:
            return
        n = st.nbytes()
        if st.device.type == "cuda":
            n = -(-n // 512) * 512
        rec = _Storage()
        rec.nbytes, rec.category = n, category
        rec.ref = weakref.ref(st, lambda _, key=key, rec=rec:
                              self._drop(key, rec))
        self._storages[key] = rec
        self.live[category] += n

    def _drop(self, key: int, rec: _Storage) -> None:
        self.live[rec.category] -= rec.nbytes
        if self._storages.get(key) is rec:
            del self._storages[key]

    def _reclassify_gradients(self) -> None:
        alive = []
        for ref in self._leaves:
            leaf = ref()
            if leaf is None:
                continue
            alive.append(ref)
            if not (leaf.is_leaf and leaf.requires_grad):
                continue
            g = leaf.grad
            if g is None:
                continue
            rec = self._storages.get(id(g.untyped_storage()))
            if rec is not None and rec.category != "gradients":
                self.live[rec.category] -= rec.nbytes
                rec.category = "gradients"
                self.live["gradients"] += rec.nbytes
        self._leaves = alive

    def _update_peak(self) -> None:
        total = sum(self.live.values())
        if total > self.peak_bytes:
            self._reclassify_gradients()
            self.peak_bytes = total
            self.peak = {c: v for c, v in self.live.items() if v}

    # -- kernels --------------------------------------------------------- #
    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, n_bytes: float):
        """A kernel wrapper's call (`repro_torch.kernels.launch.
        kernel_work`): its reported work counts, the ops inside do not;
        the storages they made that outlive the call count as its
        outputs.  A call inside another (a backward that runs its
        forward for inputs it was not given) is the outer one's work."""
        if self._kernel_depth:
            yield
            return
        self.kernel_flops[name] += int(flops)
        self.kernel_calls[name] += 1
        self.traffic[f"kernel:{name}"] += int(n_bytes)
        self.layers[self._layer()] += int(n_bytes)
        self.op_hist[f"kernel:{name}"] += 1
        self._kernel_depth += 1
        try:
            yield
        finally:
            self._kernel_depth -= 1
            if self._kernel_depth == 0:
                pending, self._pending = self._pending, []
                for st in pending:
                    self._add(st, "other")
                del pending
                self._update_peak()

    # -- the mode -------------------------------------------------------- #
    def __enter__(self):
        from torch.distributed._tools.mod_tracker import ModTracker
        self._mods = ModTracker()
        known = getattr(self._mods, "_known_modules", None)
        for model in self._models if known is not None else ():
            for name, m in model.named_modules():
                known[m] = name or type(model).__name__
        self._mods.__enter__()
        klaunch.counters.append(self)
        self._update_peak()
        return super().__enter__()

    def __exit__(self, *exc):
        self._settle()
        klaunch.counters.remove(self)
        self._mods.__exit__(*exc)
        return super().__exit__(*exc)

    def _layer(self) -> str:
        best = "other"
        for fqn in (self._mods.parents if self._mods is not None else ()):
            m = _LAYER.search(fqn)
            if m:
                best = f"layers.{m[1]}"
        return best

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        self._settle()
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self._kernel_depth:
            self._pending.extend(t.untyped_storage() for t in outs)
            return out
        name = func.overloadpacket.__name__
        self.op_hist[name] += 1
        coll = _COLLECTIVES.get(func)
        if coll is not None:
            self._collective(coll, args, kwargs, outs)
        elif not func.is_view and name not in _FREE:
            moved = sum(_nbytes(t) for t in _tensors((args, kwargs)))
            moved += sum(_nbytes(t) for t in outs)
            self.traffic[name] += moved
            self.layers[self._layer()] += moved
        count = flop_registry.get(func.overloadpacket)
        if count is not None:
            self.matmul_flops += int(count(*args, **kwargs, out_val=out))
        if func is torch.ops.aten.detach.default and outs:
            if len(self._leaves) > 4096:
                self._leaves = [r for r in self._leaves if r() is not None]
            self._leaves.append(weakref.ref(outs[0]))   # maybe a leaf
        for t in outs:
            self._add(t.untyped_storage(), "other")
        if (name in _IN_PLACE and outs
                and torch._C._current_graph_task_id() != -1
                and isinstance(args[0], torch.Tensor)
                and args[0].shape == outs[0].shape
                and args[0].dtype == outs[0].dtype):
            # perhaps in place without the counter (module notes): the
            # peak waits for the next op, by which time the first input
            # is gone if it was so
            self._deferred = self._storages.get(
                id(args[0].untyped_storage()))
            return out
        self._update_peak()
        return out

    def _settle(self) -> None:
        """The peak of a deferred out-of-place op: both buffers counted
        where its first input outlived it (then it was no in-place
        op)."""
        rec, self._deferred = self._deferred, None
        if rec is not None and rec.ref() is not None:
            self._update_peak()

    def _collective(self, coll, args, kwargs, outs) -> None:
        kind, where = coll
        res = outs if where == "out" else _tensors(args[where])
        n = sum(_nbytes(t) for t in res)
        c = self.collectives.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += n
        ranks = _group_ranks(args)
        self.collective_groups[ranks] += n
        if self.record:
            shape = tuple(res[0].shape) if res else ()
            dtype = str(res[0].dtype) if res else ""
            self.sequence.append((kind, ranks, shape, dtype))

    # -- results --------------------------------------------------------- #
    @property
    def flops(self) -> int:
        return self.matmul_flops + sum(self.kernel_flops.values())

    @property
    def traffic_bytes(self) -> int:
        return sum(self.traffic.values())

    @property
    def collective_bytes(self) -> int:
        return sum(c["bytes"] for c in self.collectives.values())

    def collective_seconds(self, rate) -> float:
        """Seconds of the collectives at ``rate(ranks)`` bytes a second
        each (`repro_torch.launch.mesh.link_bytes_per_s`)."""
        return sum(n / rate(ranks) for ranks, n in
                   self.collective_groups.items() if n)

    def summary(self) -> Dict[str, Any]:
        coll = {k: dict(v) for k, v in sorted(self.collectives.items())}
        return {
            "flops": self.flops,
            "matmul_flops": self.matmul_flops,
            "kernel_flops": dict(sorted(self.kernel_flops.items())),
            "kernel_calls": dict(sorted(self.kernel_calls.items())),
            "traffic_bytes": self.traffic_bytes,
            "traffic": traffic_breakdown(self),
            "collectives": coll,
            "collective_bytes": self.collective_bytes,
            "peak_bytes": self.peak_bytes,
            "peak": {c: self.peak.get(c, 0) for c in CATEGORIES
                     if self.peak.get(c, 0)},
            "op_hist": dict(self.op_hist.most_common()),
            "layers": hottest_layers(self, n=None),
        }


def traffic_breakdown(stats: OpStats) -> Dict[str, int]:
    """Traffic bytes by op kind, largest first (``hlo_stats``'s
    ``traffic_breakdown``)."""
    return dict(stats.traffic.most_common())


def hottest_layers(stats: OpStats, n: Optional[int] = 5
                   ) -> Dict[str, int]:
    """Traffic bytes by layer, largest first (``hlo_stats``'s
    ``loop_summary``: the port's step runs each layer once a microbatch,
    so a layer's traffic is what a loop body times its trips was)."""
    return dict(stats.layers.most_common(n))


def op_histogram(stats: OpStats) -> Dict[str, int]:
    """Calls by op, most first (``hlo_stats``'s ``op_histogram``)."""
    return dict(stats.op_hist.most_common())


def roofline(stats: OpStats, peak_flops: float, mem_rate: float,
             link_rate) -> Dict[str, float]:
    """The three roofline terms of a step on this rank, in seconds."""
    return {"t_compute": stats.flops / peak_flops,
            "t_memory": stats.traffic_bytes / mem_rate,
            "t_collective": stats.collective_seconds(link_rate)}

