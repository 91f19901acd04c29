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

The serving plans' parameters are the JAX package's serving layout:
bfloat16 except `F32_LEAVES`, tensor parallelism on ``model`` and, for
``fsdp_tp`` / ``ep_tp``, dense weights or experts on ``data`` (gathered
a layer at a time as the step runs).  Their caches follow
`repro_torch.core.fl_step.cache_layout` through
`repro_torch.models.transformer.cache_specs`, a cache a layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from ..configs import get_config
from ..core import fl_step as fl
from ..core.sharding import placements
from ..models.transformer import (cache_specs, param_specs, seeded_params,
                                  structure)
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
    """A spec tree (a `TrainState` of specs, dicts, lists, spec tuples)
    -> the same tree of placements on ``mesh``."""
    if isinstance(specs, fl.TrainState):
        return fl.TrainState(_place(specs.params, mesh),
                             _place(specs.opt, mesh), placements((), mesh))
    if isinstance(specs, dict):
        return {k: _place(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_place(v, mesh) for v in specs]
    return placements(specs, mesh)


def applicable(arch_id: str, shape_name: str) -> Optional[str]:
    """None if runnable, else a skip reason."""
    cfg = get_config(arch_id)
    if shape_name == "long_500k" and not cfg.subquadratic \
            and cfg.sliding_variant_window <= 0:
        return LONG_SKIP_REASON
    return None


def _real(t: torch.Tensor, device, gen: torch.Generator, high: int = 0
          ) -> torch.Tensor:
    """A meta tensor's counterpart on ``device``: token ids below ``high``
    (int tensors), or ones (weights: a batch's rows weighted alike)."""
    if t.dtype in (torch.int32, torch.int64):
        return torch.randint(0, high, tuple(t.shape), generator=gen,
                             dtype=t.dtype).to(device)
    return torch.ones(t.shape, dtype=t.dtype, device=device)


def train_plan(arch_id: str, shape_name: str, mesh,
               param_dtype=torch.bfloat16, cfg=None, seq=None,
               global_batch=None, device="meta", seed: int = 0) -> Plan:
    """The sharded federated training step of ``arch_id`` at
    ``shape_name`` on ``mesh``, as the JAX package plans it: the
    architecture's mode, clusters on ``pod``, Adafactor (bfloat16 update
    math and gradient buffer past 30B parameters), and its batch layout.
    The JAX package's ``q_chunk`` (query chunks bounding the score tensor)
    has no counterpart: the flash-attention kernel never holds the scores
    (`repro_torch.models.transformer.LM.prefill`).  Its ``sequential``
    Adafactor bounds XLA's temporaries; the port's step updates leaf by
    leaf already.

    ``cfg``, ``seq``, ``global_batch``: a config of the architecture cut
    in depth and a shorter or smaller batch (a run at example scale).
    ``device``: where the arguments are made, the meta device (abstract:
    nothing allocated) unless asked; elsewhere the model is drawn from
    ``seed`` and the tokens from a generator seeded with it, whole (place
    them with `distribute_state` / `distribute_batch` of ``in_specs``)."""
    cut = cfg
    cfg = cfg or get_config(arch_id)
    spec = SHAPES[shape_name]
    seq = seq or spec["seq"]
    gbatch = global_batch or spec["global_batch"]
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
                            clients_per_cluster=n_data, device=device)
    state = init(seed)
    state = state._replace(params={
        k: v if k.rsplit(".", 1)[-1] in F32_LEAVES else v.to(param_dtype)
        for k, v in state.params.items()})
    state_specs = fl.train_state_specs(cfg, state, mode=mode,
                                       opt_name="adafactor",
                                       pod_axis=pod_axis, tp_size=tp_size)
    batch_sp = fl.batch_specs(cfg, batch, mode=mode, pod_axis=pod_axis)
    rep = _meta((NC, n_data if mode == fl.MODE_A else 1), torch.float32)
    stale = _meta((NC,), torch.float32)
    if torch.device(device).type != "meta":
        gen = torch.Generator().manual_seed(seed)
        batch = {k: _real(v, device, gen, cfg.vocab_size)
                 for k, v in batch.items()}
        rep, stale = (_real(t, device, gen) / t.shape[-1]
                      for t in (rep, stale))

    step = fl.build_train_step(cfg, opt, mode=mode, local_steps=1,
                               accum_dtype=accum_dtype)
    in_specs = (state_specs, batch_sp, (None, None), (None,))
    in_sh = tuple(_place(s, mesh) for s in in_specs)
    return Plan(arch_id, shape_name, "train", step,
                (state, batch, rep, stale), in_specs, in_sh,
                (in_sh[0], None), cfg, donate=(0,),
                options={"accum_dtype": accum_dtype,
                         "compute_dtype": torch.bfloat16 if big else None,
                         "q_chunk": None, "mesh": mesh,
                         "build": dict(param_dtype=param_dtype, cfg=cut,
                                       seq=seq, global_batch=gbatch)})


def _serve_cfg(arch_id: str, shape_name: str, cfg=None):
    """The architecture's config (or ``cfg``, e.g. cut in depth), as
    long_500k swaps its global attention for the declared sliding
    window (`ArchConfig.long_context_variant`: it raises for a
    full-attention config without one, as the JAX package's does)."""
    cfg = cfg or get_config(arch_id)
    if shape_name == "long_500k" and not cfg.subquadratic:
        cfg = cfg.long_context_variant()
    return cfg


def _serve_params(cfg, param_dtype=torch.bfloat16, device="meta",
                  seed: int = 0):
    """The model's parameters in the serving dtypes: ``param_dtype``
    except `F32_LEAVES`; meta tensors, or on ``device`` drawn from
    ``seed`` (`seeded_params`, a layer at a time)."""
    cast = lambda k, v: (v if k.rsplit(".", 1)[-1] in F32_LEAVES
                         else v.to(param_dtype))
    if torch.device(device).type != "meta":
        return seeded_params(cfg, seed, device=device, keep=cast)
    return {k: cast(k, v) for k, v in structure(cfg).named_parameters()}


def _real_cache(cache, device):
    """An empty decode cache like the meta ``cache``, on ``device``: zero
    states and entries, every slot's position -1 (unwritten)."""
    if isinstance(cache, list):
        return [_real_cache(c, device) for c in cache]
    return {k: (torch.full(v.shape, -1, dtype=v.dtype, device=device)
                if k == "pos" else
                torch.zeros(v.shape, dtype=v.dtype, device=device))
            for k, v in cache.items()}


def _serve_param_specs(cfg, tp_size, params=None):
    """-> (the serving parameters (meta), their specs): tensor parallelism
    on ``model``; dense weights (``fsdp_tp``) or experts (``ep_tp``) on
    ``data``."""
    fsdp = "data" if cfg.shard_scheme in ("ep_tp", "fsdp_tp") else None
    stack_axis = "data" if cfg.shard_scheme == "stack_tp" else None
    shapes = _serve_params(cfg) if params is None else params
    return shapes, param_specs(shapes, cfg, tp="model", fsdp=fsdp,
                               stack_axis=stack_axis, tp_size=tp_size)


def _serve_layout(cfg, shape_name, mesh):
    spec = SHAPES[shape_name]
    seq, batch = spec["seq"], spec["global_batch"]
    tp_size = axis_size(mesh, "model")
    layout = fl.cache_layout(cfg, batch, axis_size(mesh, "data"), tp_size)
    return seq, batch, tp_size, layout


def decode_plan(arch_id: str, shape_name: str, mesh,
                param_dtype=torch.bfloat16, cfg=None, device="meta",
                seed: int = 0) -> Plan:
    """One decode step of ``arch_id`` at ``shape_name`` on ``mesh``, as the
    JAX package plans it: (parameters, cache, tokens, step) at the serving
    layout, the cache updated in place (``donate``).  ``applicable``'s
    skip reason rides along.  ``cfg``: a config of the architecture cut
    in depth (a smoke run); ``param_dtype`` float32 for such a run's
    weights.  ``device``: where the arguments are made (`train_plan`'s):
    elsewhere than meta the weights are drawn from ``seed``, the cache is
    empty, the tokens are drawn and the step is the cache's middle."""
    skip = applicable(arch_id, shape_name)
    cut = cfg
    cfg = _serve_cfg(arch_id, shape_name, cfg)
    seq, batch, tp_size, layout = _serve_layout(cfg, shape_name, mesh)
    pshapes, pspecs = _serve_param_specs(
        cfg, tp_size, _serve_params(cfg, param_dtype, device, seed))
    cache = structure(cfg).init_cache(batch, seq)
    cspecs = cache_specs(cache, **layout)
    if cfg.num_codebooks > 1:
        tok = _meta((batch, cfg.num_codebooks), torch.int32)
        tok_spec = (layout["batch_axis"], None)
    else:
        tok = _meta((batch,), torch.int32)
        tok_spec = (layout["batch_axis"],)
    step_pos = _meta((), torch.int32)
    if torch.device(device).type != "meta":
        gen = torch.Generator().manual_seed(seed)
        cache = _real_cache(cache, device)
        tok = _real(tok, device, gen, cfg.vocab_size)
        step_pos = torch.tensor(seq // 2, dtype=torch.int32, device=device)
    in_specs = (pspecs, cspecs, tok_spec, ())
    in_sh = tuple(_place(sp, mesh) for sp in in_specs)
    return Plan(arch_id, shape_name, "decode", fl.build_serve_step(cfg),
                (pshapes, cache, tok, step_pos), in_specs, in_sh,
                (None, in_sh[1]), cfg, donate=(1,), skip=skip,
                options={"layout": layout, "mesh": mesh,
                         "build": dict(param_dtype=param_dtype, cfg=cut)})


def prefill_plan(arch_id: str, shape_name: str, mesh,
                 param_dtype=torch.bfloat16, cfg=None, device="meta",
                 seed: int = 0) -> Plan:
    """The serving prefill of ``arch_id`` at ``shape_name`` on ``mesh``, as
    the JAX package plans it: (parameters, tokens) -> (logits, the cache
    of ``seq`` positions at the serving layout).  The JAX package's
    ``q_chunk=1024`` has no counterpart (`LM.prefill`).  ``cfg``,
    ``param_dtype``, ``device``, ``seed``: as in `decode_plan`."""
    cut = cfg
    cfg = _serve_cfg(arch_id, shape_name, cfg)
    seq, batch, tp_size, layout = _serve_layout(cfg, shape_name, mesh)
    pshapes, pspecs = _serve_param_specs(
        cfg, tp_size, _serve_params(cfg, param_dtype, device, seed))
    cspecs = cache_specs(structure(cfg).init_cache(
        batch, seq), **layout)
    tok = _token_struct(cfg, (), batch, seq)
    if torch.device(device).type != "meta":
        tok = _real(tok, device, torch.Generator().manual_seed(seed),
                    cfg.vocab_size)
    tok_spec = (layout["batch_axis"],) + (None,) * (tok.dim() - 1)
    in_specs = (pspecs, tok_spec)
    in_sh = tuple(_place(sp, mesh) for sp in in_specs)
    return Plan(arch_id, shape_name, "prefill",
                fl.build_prefill_step(cfg, seq), (pshapes, tok), in_specs,
                in_sh, (None, _place(cspecs, mesh)), cfg,
                options={"layout": layout, "cache_specs": cspecs,
                         "q_chunk": None, "mesh": mesh,
                         "build": dict(param_dtype=param_dtype, cfg=cut)})


def make_plan(arch_id: str, shape_name: str, mesh, **kw) -> Plan:
    """The plan of ``shape_name``'s kind; ``kw`` go to its builder (a cut
    ``cfg``, ``device`` and ``seed``; a training plan's ``seq`` and
    ``global_batch``)."""
    kind = SHAPES[shape_name]["kind"]
    if kind == "train":
        return train_plan(arch_id, shape_name, mesh, **kw)
    if kind == "prefill":
        return prefill_plan(arch_id, shape_name, mesh, **kw)
    return decode_plan(arch_id, shape_name, mesh, **kw)


def materialize(plan: Plan, device, seed: int = 0) -> Plan:
    """``plan`` made again with its arguments on ``device``, drawn from
    ``seed`` (its builder's ``device`` / ``seed``)."""
    return make_plan(plan.arch, plan.shape, plan.options["mesh"],
                     device=device, seed=seed, **plan.options["build"])
