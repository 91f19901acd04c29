"""The serving plans of the port against the JAX package's, leaf for leaf.

The ten architectures x ``prefill_32k``, ``decode_32k`` and ``long_500k``
on both production meshes (16x16 and 2x16x16, on a fake process group of
256 then 512 ranks in one subprocess, started with the file's first
test): every parameter's shape, dtype and spec (the serving layout:
bfloat16 except the float32 leaves, tensor parallelism on ``model``,
FSDP or experts on ``data``), every cache leaf's (the JAX package's
stacked caches through `unstack_layers`), the tokens', the placements of
each spec on the mesh, and the skip reasons; a full-attention
architecture without a sliding-window variant raises the JAX package's
error for long_500k.  The JAX side is the JAX package's own plan
functions (``_serve_cfg``, ``_serve_param_specs``, ``_cache_layout``,
``cache_specs``, ``applicable``) at the meshes' axis sizes.
"""
from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)
import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import all_arch_ids  # noqa: E402
from repro.launch import plans as jplans  # noqa: E402
from repro.models.transformer import cache_specs as jax_cache_specs  # noqa
from repro.models.transformer import init_cache as jax_init_cache  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import plans as tplans  # noqa: E402
from repro_torch.models.transformer import (named_from_tree,  # noqa: E402
                                            unstack_layers)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCHS = all_arch_ids()
SHAPES = ("prefill_32k", "decode_32k", "long_500k")
MESHES = {"16x16": ("data", "model"), "2x16x16": ("pod", "data", "model")}
PLAN_TIMEOUT = 240                # seconds, the plan subprocess

TORCH_PLANS = r"""
import json
import torch.distributed as dist
from repro_torch.configs import ARCH_IDS
from repro_torch.launch.mesh import make_production_mesh, n_chips
from repro_torch.launch.plans import make_plan

def leaf(x, s, pl):
    return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "spec": [list(e) if isinstance(e, tuple) else e for e in s],
            "placements": [["S", q.dim] if q.is_shard() else ["R"]
                           for q in pl]}

def tree(t, s, pl):
    if isinstance(t, dict):
        return {k: tree(t[k], s[k], pl[k]) for k in t}
    if isinstance(t, list):
        return [tree(a, b, c) for a, b, c in zip(t, s, pl)]
    return leaf(t, s, pl)

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi, fake=True)
    assert n_chips(mesh) == (512 if multi else 256)
    tag = "2x16x16" if multi else "16x16"
    for a in ARCH_IDS:
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            key = f"{a}@{shape}@{tag}"
            try:
                p = make_plan(a, shape, mesh)
            except ValueError as e:
                out[key] = {"error": str(e)}
                continue
            if p.kind == "prefill":
                params, tok = p.args
                psp, tsp = p.in_specs
                psh, tsh = p.in_shardings
                cache = p.options["cache_specs"]
                csh = p.out_shardings[1]
                cshape = None
            else:
                params, cshape, tok, _ = p.args
                psp, cache, tsp, _ = p.in_specs
                psh, csh, tsh, _ = p.in_shardings
                assert p.out_shardings[1] is csh and p.donate == (1,)
            out[key] = {
                "kind": p.kind, "skip": p.skip,
                "params": tree(params, psp, psh),
                "cache_specs": [{k: [list(e) if isinstance(e, tuple) else e
                                     for e in s] for k, s in c.items()}
                                for c in cache],
                "cache": (None if cshape is None else
                          tree(cshape, cache, csh)),
                "tokens": leaf(tok, tsp, tsh)}
    dist.destroy_process_group()
print("PLANS" + json.dumps(out))
"""


def _run(script, env_extra):
    env = dict(os.environ, PYTHONPATH=SRC, **env_extra)
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=PLAN_TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.split("PLANS", 1)[1])


@pytest.fixture(scope="module", autouse=True)
def started_plans():
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(_run, TORCH_PLANS, {"OMP_NUM_THREADS": "1"})
    pool.shutdown(wait=True)


# ---------------------------------------------------------------------- #
# the JAX package's plans, through its own plan functions
# ---------------------------------------------------------------------- #
class _Leaf:
    """A JAX leaf's shape, dtype and spec, which `unstack_layers` can
    index like an array: a group leaf's layer drops its stack dim."""

    def __init__(self, shape, dtype, spec):
        self.shape, self.dtype, self.spec = tuple(shape), dtype, spec

    def __getitem__(self, idx):
        d = len(idx) - 1
        drop = lambda t: tuple(t[:d]) + tuple(t[d + 1:])   # noqa: E731
        return _Leaf(drop(self.shape), self.dtype, drop(self.spec))


def _leaves(shapes, specs):
    return jax.tree.map(lambda x, s: _Leaf(x.shape, str(x.dtype), tuple(s)),
                        shapes, specs, is_leaf=lambda x: isinstance(x, P))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, long: bool, tp_size):
    """The JAX package's serving parameters of ``arch`` (its long_500k
    variant with ``long``) under the port's names, as `_Leaf`s."""
    cfg = jplans._serve_cfg(arch, "long_500k" if long else "decode_32k")
    tcfg = get_config(arch)
    if long:
        tcfg = tcfg.long_context_variant()
    return named_from_tree(_leaves(*jplans._serve_param_specs(cfg, tp_size)),
                           tcfg)


def _ported(message: str) -> str:
    """The JAX package's message as the port words it: without the
    pointer to a design note this repository does not hold."""
    return message.replace(" (see DESIGN.md)", "")


@functools.lru_cache(maxsize=None)
def jax_plan(arch, shape, tp_size=16, n_data=16):
    """The JAX package's serving plan of ``arch`` at ``shape``: its skip
    reason, parameters and caches (one dict a layer) as `_Leaf`s, its
    tokens' shape and spec; or the error its config raises."""
    skip = jplans.applicable(arch, shape) if SHAPE_KIND[shape] == "decode" \
        else None
    try:
        cfg = jplans._serve_cfg(arch, shape)
    except ValueError as e:
        return {"error": str(e)}
    spec = jplans.SHAPES[shape]
    seq, batch = spec["seq"], spec["global_batch"]
    layout = jplans._cache_layout(cfg, batch, n_data, tp_size)
    cshapes = jax.eval_shape(functools.partial(jax_init_cache, cfg, batch,
                                               seq))
    cspecs = jax_cache_specs(cshapes, **layout)
    tcfg = get_config(arch)
    if shape == "long_500k":
        tcfg = tcfg.long_context_variant()
    if SHAPE_KIND[shape] == "decode":
        tok = (batch, cfg.num_codebooks) if cfg.num_codebooks > 1 else (
            batch,)
    else:
        tok = (batch, cfg.num_codebooks, seq) if cfg.num_codebooks > 1 \
            else (batch, seq)
    tok_spec = (layout["batch_axis"],) + (None,) * (len(tok) - 1)
    return {"skip": skip,
            "params": _jax_params(arch, shape == "long_500k", tp_size),
            "cache": unstack_layers(_leaves(cshapes, cspecs), tcfg),
            "tokens": (tok, "int32", tok_spec)}


SHAPE_KIND = {k: v["kind"] for k, v in jplans.SHAPES.items()}


def _spec(s):
    return tuple(tuple(e) if isinstance(e, list) else e for e in s)


def _placements_of(spec, names):
    out = [["R"]] * len(names)
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            out[names.index(a)] = ["S", d]
    return out


def _same_leaf(got, want, names, where):
    assert tuple(got["shape"]) == want.shape, where
    assert got["dtype"] == want.dtype, where
    assert _spec(got["spec"]) == want.spec, where
    assert got["placements"] == _placements_of(want.spec, names), where


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serving_plans_equal_the_jax_packages(started_plans, mesh, shape):
    plans = started_plans.result()
    names = MESHES[mesh]
    for arch in ARCHS:
        got, want = plans[f"{arch}@{shape}@{mesh}"], jax_plan(arch, shape)
        if "error" in want:
            assert got == {"error": _ported(want["error"])}, arch
            continue
        assert got["kind"] == SHAPE_KIND[shape]
        assert got["skip"] == want["skip"], arch
        assert set(got["params"]) == set(want["params"]), arch
        for k, w in want["params"].items():
            _same_leaf(got["params"][k], w, names, (arch, k))
        assert len(got["cache_specs"]) == len(want["cache"]), arch
        for i, (gc, wc) in enumerate(zip(got["cache_specs"], want["cache"])):
            assert set(gc) == set(wc), (arch, i)
            for k, w in wc.items():
                assert _spec(gc[k]) == w.spec, (arch, i, k)
                if got["cache"] is not None:
                    _same_leaf(got["cache"][i][k], w, names, (arch, i, k))
        tok, dtype, spec = want["tokens"]
        t = got["tokens"]
        assert (tuple(t["shape"]), t["dtype"], _spec(t["spec"])) == (
            tok, dtype, spec), arch
        assert t["placements"] == _placements_of(spec, names)


def test_skip_reasons_and_refusals_equal_the_jax_packages():
    """``applicable`` gives the JAX package's reason for every pair, and a
    config that has no long_500k variant raises its error."""
    for arch in ARCHS:
        for shape in SHAPES:
            assert tplans.applicable(arch, shape) == jplans.applicable(
                arch, shape)
            try:
                jplans._serve_cfg(arch, shape)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tplans._serve_cfg(arch, shape)
                assert str(got.value) == _ported(str(e))
