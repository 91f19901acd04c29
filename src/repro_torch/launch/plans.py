"""Lowering plans (the JAX package's ``launch/plans.py``): architecture x
input shape x mesh -> a step function, its abstract arguments and their
placements.

Abstract arguments are tensors on the ``meta`` device (the counterpart of
``jax.ShapeDtypeStruct``): a plan at a production mesh of 512 ranks
(`repro_torch.launch.mesh.make_production_mesh(fake=True)`) allocates
nothing.  DTensor placements stand in for ``NamedSharding``: ``in_specs``
holds the specs (`repro_torch.core.sharding`'s tuples), ``in_shardings``
the placements they give on the plan's mesh.  Concrete arguments at
example scale come from `distribute_state` / `distribute_batch` of the
same specs, and ``step_fn`` runs on them.

Only the training plan is ported: the serving plans (``prefill_plan``,
``decode_plan``, the cache layouts) wait for ROADMAP.md, queue 1,
item 9.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs import get_config
from ..core import fl_step as fl
from ..core.sharding import placements
from ..optim import adafactor
from .mesh import axis_size

SHAPES = {
    "train_4k":    dict(kind="train",   seq=4096,   global_batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768,  global_batch=32),
    "decode_32k":  dict(kind="decode",  seq=32768,  global_batch=128),
    "long_500k":   dict(kind="decode",  seq=524288, global_batch=1),
}

# leaves the JAX package's init keeps in float32 whatever the parameter
# dtype: norms, the router, the recurrences' vectors
F32_LEAVES = {"A_log", "D", "b_a", "b_i", "dt_bias", "final_norm", "knorm",
              "kv_norm", "lam", "ln1", "ln2", "q_norm", "qnorm", "router"}

# archs whose long_500k is inapplicable (pure full attention, no declared
# sliding-window variant)
LONG_SKIP_REASON = "skipped(full-attn)"


@dataclasses.dataclass
class Plan:
    arch: str
    shape: str
    kind: str
    step_fn: Callable
    args: tuple                  # meta (abstract) or concrete arguments
    in_specs: tuple              # specs of args (None: whole on every rank)
    in_shardings: tuple          # the specs' placements on the mesh
    out_shardings: Any
    cfg: Any
    donate: tuple = ()           # arguments the step updates in place
    skip: Optional[str] = None
    options: dict = dataclasses.field(default_factory=dict)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_struct(cfg, lead, batch, seq):
    if cfg.num_codebooks > 1:
        return _meta(lead + (batch, cfg.num_codebooks, seq), torch.int32)
    return _meta(lead + (batch, seq), torch.int32)


def _place(specs, mesh):
    """A spec tree (a `TrainState` of specs, dicts, spec tuples) -> the
    same tree of placements on ``mesh``."""
    if isinstance(specs, fl.TrainState):
        return fl.TrainState(_place(specs.params, mesh),
                             _place(specs.opt, mesh), placements((), mesh))
    if isinstance(specs, dict):
        return {k: _place(v, mesh) for k, v in specs.items()}
    return placements(specs, mesh)


def applicable(arch_id: str, shape_name: str) -> Optional[str]:
    """None if runnable, else a skip reason."""
    cfg = get_config(arch_id)
    if shape_name == "long_500k" and not cfg.subquadratic \
            and cfg.sliding_variant_window <= 0:
        return LONG_SKIP_REASON
    return None


def train_plan(arch_id: str, shape_name: str, mesh,
               param_dtype=torch.bfloat16) -> Plan:
    """The sharded federated training step of ``arch_id`` at
    ``shape_name`` on ``mesh``, as the JAX package plans it: the
    architecture's mode, clusters on ``pod``, Adafactor (bfloat16 update
    math and gradient buffer past 30B parameters), and its batch layout.
    The JAX package's ``q_chunk`` (query chunks bounding the score tensor)
    has no counterpart: the flash-attention kernel never holds the scores
    (`repro_torch.models.transformer.LM.prefill`).  Its ``sequential``
    Adafactor bounds XLA's temporaries; the port's step updates leaf by
    leaf already."""
    cfg = get_config(arch_id)
    spec = SHAPES[shape_name]
    seq, gbatch = spec["seq"], spec["global_batch"]
    n_pods = axis_size(mesh, "pod")
    n_data = axis_size(mesh, "data")
    tp_size = axis_size(mesh, "model")
    pod_axis = "pod" if n_pods > 1 else None
    mode = cfg.fl_mode
    NC = max(n_pods, 1)

    big = cfg.param_count() * (2 if param_dtype == torch.bfloat16 else 4) \
        > 30e9 * 2
    accum_dtype = torch.bfloat16 if big else torch.float32
    opt = adafactor(1e-2, compute_dtype=torch.bfloat16 if big else None)

    if mode == fl.MODE_A:
        C = n_data
        per_client = max(1, gbatch // (NC * C))
        bm = min(2, per_client)
        n_micro = max(1, per_client // bm)
        lead = (NC, C, n_micro, bm)
        batch = {"tokens": _token_struct(cfg, lead[:-1], bm, seq),
                 "labels": _token_struct(cfg, lead[:-1], bm, seq)}
    else:
        bm = n_data
        n_micro = max(1, gbatch // (NC * bm))
        lead = (NC, n_micro, bm)
        batch = {"tokens": _token_struct(cfg, lead[:-1], bm, seq),
                 "labels": _token_struct(cfg, lead[:-1], bm, seq),
                 "weights": _meta((NC, n_micro, bm), torch.float32)}

    init = fl.build_init_fn(cfg, opt, mode=mode, n_clusters=NC,
                            clients_per_cluster=n_data, device="meta")
    state = init()
    state = state._replace(params={
        k: v if k.rsplit(".", 1)[-1] in F32_LEAVES else v.to(param_dtype)
        for k, v in state.params.items()})
    state_specs = fl.train_state_specs(cfg, state, mode=mode,
                                       opt_name="adafactor",
                                       pod_axis=pod_axis, tp_size=tp_size)
    batch_sp = fl.batch_specs(cfg, batch, mode=mode, pod_axis=pod_axis)
    rep = _meta((NC, n_data if mode == fl.MODE_A else 1), torch.float32)
    stale = _meta((NC,), torch.float32)

    step = fl.build_train_step(cfg, opt, mode=mode, local_steps=1,
                               accum_dtype=accum_dtype)
    in_specs = (state_specs, batch_sp, (None, None), (None,))
    in_sh = tuple(_place(s, mesh) for s in in_specs)
    return Plan(arch_id, shape_name, "train", step,
                (state, batch, rep, stale), in_specs, in_sh,
                (in_sh[0], None), cfg, donate=(0,),
                options={"accum_dtype": accum_dtype,
                         "compute_dtype": torch.bfloat16 if big else None,
                         "q_chunk": None})


def make_plan(arch_id: str, shape_name: str, mesh) -> Plan:
    kind = SHAPES[shape_name]["kind"]
    if kind == "train":
        return train_plan(arch_id, shape_name, mesh)
    raise NotImplementedError(
        f"the {kind} plan ({shape_name}) is not ported: the serving plans "
        "(prefill_plan, decode_plan, cache_specs and their cache layouts) "
        "wait for ROADMAP.md, queue 1, item 9")
