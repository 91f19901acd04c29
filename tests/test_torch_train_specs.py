"""The sharding specs and the training plan of the port against the JAX
package's, leaf for leaf, as tuples.

* `param_specs` of all ten architectures at full width (the JAX package's
  abstract shapes through ``jax.eval_shape``: no weights) and at smoke
  size, in the JAX tree layout and in the port's parameter names; mode
  A's ``leading=('pod', 'data')``, mode B's FSDP / expert-parallel
  ``data`` axis, ``tp_size`` 16 and 4 (whether the experts shard follows
  it), ``ep_size`` and ``stack_axis``.
* `train_state_specs` for SGD (with and without momentum), Adam, AdamW and
  Adafactor; `batch_specs` in both modes.
* `train_plan` at the production meshes 16x16 and 2x16x16 for the ten
  architectures x ``train_4k``: every argument's shape, dtype and spec,
  the JAX package's ``make_plan`` in one subprocess on 512 forced host
  devices, the port's in one on a fake process group of 256 then 512
  ranks, both started with the file's first test.
* The guards: a sharded datacenter `FederationSpec` raises the JAX
  package's error, the prefill and decode plans raise naming the ROADMAP
  item, and the new modules import no JAX.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.api import spec as jspec  # noqa: E402
from repro.configs import all_arch_ids  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import fl_step as jfl  # noqa: E402
from repro.models import init_params  # noqa: E402
from repro.models import param_specs as jax_param_specs  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.api import spec as tspec  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import fl_step as tfl  # noqa: E402
from repro_torch.models.transformer import (LM, named_from_tree,  # noqa
                                            param_specs)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCHS = all_arch_ids()
PLAN_TIMEOUT = 240                # seconds, each plan subprocess
SPEC_KW = {
    "tp": dict(),
    "modeA-tp4": dict(leading=("pod", "data"), tp_size=4),
    "modeB": dict(fsdp="data", leading=("pod",)),
    "modeB-tp4-ep4": dict(fsdp="data", leading=("pod",), tp_size=4,
                          ep_size=4),
    "stack": dict(fsdp="data", stack_axis="data", tp_size=4),
}


# ---------------------------------------------------------------------- #
# tree plumbing: the JAX tree's leaves under the port's names
# ---------------------------------------------------------------------- #
def _tup(p):
    return tuple(p)


class _Leaf:
    """A JAX leaf's shape, dtype and spec, which `named_from_tree` can
    index like an array: a group leaf's layer ``g`` drops its stack dim."""

    def __init__(self, shape, dtype=None, spec=None):
        self.shape, self.dtype, self.spec = tuple(shape), dtype, spec

    def __getitem__(self, idx):
        d = len(idx) - 1
        drop = lambda t: None if t is None else tuple(t[:d]) + tuple(
            t[d + 1:])
        return _Leaf(drop(self.shape), self.dtype, drop(self.spec))


def _flat(tree, prefix=""):
    """A (nested) dict -> {"name/sub": leaf}: the port's names, with an
    optimizer's per-leaf dicts ("r", "c", "v") as a suffix."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) and "shape" not in v:     # not a JSON leaf
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


def _named(tree, cfg, lead):
    """The JAX parameter-shaped tree (leaves, or per-leaf dicts) -> the
    port's flat names."""
    named = named_from_tree(tree, cfg, lead)
    out = {}
    for k, v in named.items():
        if isinstance(v, dict):
            out.update(_flat(v, k + "/"))
        else:
            out[k] = v
    # a nested leaf dict flattened by `named_from_tree` ("x.r") reads as
    # the port's ("x/r")
    return {(k.rsplit(".", 1)[0] + "/" + k.rsplit(".", 1)[1]
             if k.rsplit(".", 1)[-1] in ("r", "c", "v") and "/" not in k
             else k): v for k, v in out.items()}


def _spec_leaves(tree, lead, cfg):
    wrap = jax.tree.map(lambda p: _Leaf((0,) * len(p), spec=_tup(p)), tree,
                        is_leaf=lambda x: isinstance(x, P))
    return {k: v.spec for k, v in _named(wrap, cfg, lead).items()}


def _abstract(cfg):
    return jax.eval_shape(lambda k: init_params(k, cfg, jnp.bfloat16),
                          jax.random.PRNGKey(0))


# ---------------------------------------------------------------------- #
# the plan subprocesses
# ---------------------------------------------------------------------- #
JAX_PLANS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import all_arch_ids
from repro.launch.mesh import make_production_mesh
from repro.launch.plans import make_plan

def leaf(x, s):
    return {"shape": list(x.shape), "dtype": str(x.dtype),
            "spec": [list(e) if isinstance(e, tuple) else e
                     for e in s.spec]}

def tree(shapes, shardings):
    pairs = jax.tree.map(leaf, shapes, shardings,
                         is_leaf=lambda x: isinstance(x, NamedSharding))
    return pairs

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    tag = "2x16x16" if multi else "16x16"
    for a in all_arch_ids():
        p = make_plan(a, "train_4k", mesh)
        st, batch, rep, stale = p.args
        ssh, bsh, rsh, tsh = p.in_shardings
        out[f"{a}@{tag}"] = {
            "params": tree(st.params, ssh.params),
            "opt": tree(st.opt, ssh.opt),
            "batch": tree(batch, bsh), "rep": leaf(rep, rsh),
            "stale": leaf(stale, tsh), "out_is_in": True}
print("PLANS" + json.dumps(out))
"""

TORCH_PLANS = r"""
import json, sys
import torch.distributed as dist
from repro_torch.configs import ARCH_IDS
from repro_torch.launch.mesh import make_production_mesh, n_chips
from repro_torch.launch.plans import make_plan
from repro_torch.core.sharding import placements

def leaf(x, s, pl):
    return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "spec": [list(e) if isinstance(e, tuple) else e for e in s],
            "placements": [["S", q.dim] if q.is_shard() else ["R"]
                           for q in pl]}

def tree(t, s, pl):
    if isinstance(t, dict):
        return {k: tree(t[k], s[k], pl[k]) for k in t}
    return leaf(t, s, pl)

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi, fake=True)
    assert n_chips(mesh) == (512 if multi else 256)
    tag = "2x16x16" if multi else "16x16"
    for a in ARCH_IDS:
        p = make_plan(a, "train_4k", mesh)
        st, batch, rep, stale = p.args
        ssp, bsp, rsp, tsp = p.in_specs
        ssh, bsh, rsh, tsh = p.in_shardings
        out[f"{a}@{tag}"] = {
            "params": tree(st.params, ssp.params, ssh.params),
            "opt": tree(st.opt, ssp.opt, ssh.opt),
            "batch": tree(batch, bsp, bsh),
            "rep": leaf(rep, rsp, rsh), "stale": leaf(stale, tsp, tsh),
            "out_is_in": p.out_shardings[0] is ssh,
            "options": {k: str(v) for k, v in p.options.items()}}
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
    pool = concurrent.futures.ThreadPoolExecutor(2)
    yield {"jax": pool.submit(_run, JAX_PLANS, {"JAX_PLATFORMS": "cpu"}),
           "torch": pool.submit(_run, TORCH_PLANS, {"OMP_NUM_THREADS": "1"})}
    pool.shutdown(wait=True)


# ---------------------------------------------------------------------- #
# param_specs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_jax_packages(arch, size):
    jcfg = (jax_config if size == "full" else jax_smoke)(arch)
    tcfg = (get_config if size == "full" else get_smoke_config)(arch)
    shapes = _abstract(jcfg)
    named = dict(LM(tcfg, device="meta", seed=None).named_parameters())
    for tag, kw in SPEC_KW.items():
        want = jax_param_specs(shapes, jcfg, **kw)
        # the JAX tree layout, leaf for leaf
        got = param_specs(shapes, tcfg, **kw)
        wl = jax.tree.leaves(jax.tree.map(_tup, want, is_leaf=lambda x:
                                          isinstance(x, P)),
                             is_leaf=lambda x: isinstance(x, tuple))
        gl = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
        assert wl == gl, tag
        # the port's names: a group leaf's spec without its stack dim
        if kw.get("stack_axis") or kw.get("leading"):
            continue
        mine = param_specs(named, tcfg, **kw)
        assert mine == _spec_leaves(want, 0, tcfg), tag


# ---------------------------------------------------------------------- #
# train_state_specs, batch_specs
# ---------------------------------------------------------------------- #
OPTS = {"sgd": (lambda m: jopt.sgd(0.1), lambda m: topt.sgd(0.1)),
        "sgd-momentum": (lambda m: jopt.sgd(0.1, 0.9),
                         lambda m: topt.sgd(0.1, 0.9)),
        "adam": (lambda m: jopt.adam(1e-3), lambda m: topt.adam(1e-3)),
        "adamw": (lambda m: jopt.adamw(1e-3), lambda m: topt.adamw(1e-3)),
        "adafactor": (lambda m: jopt.adafactor(1e-2),
                      lambda m: topt.adafactor(1e-2))}


def _known_adafactor_split(want: dict, got: dict, cfg) -> None:
    """The one layout the two packages' Adafactor states differ in: the
    JAX package stacks a group's layers, so a 1-D parameter of a group is
    a (G, n) leaf whose moments it factors into rows (G,) and columns
    (n,); the port keeps each layer's (n,) leaf and its full moment
    ``v``.  Every other leaf's moments and specs agree."""
    extra_w = {k.rsplit("/", 1)[0] for k in set(want) - set(got)}
    extra_g = {k.rsplit("/", 1)[0] for k in set(got) - set(want)}
    assert extra_w == extra_g
    shapes = dict(LM(cfg, device="meta", seed=None).named_parameters())
    for k in extra_g:
        assert shapes[k].dim() == 1, k
        assert {f"{k}/r", f"{k}/c"} <= set(want) and f"{k}/v" in got


@pytest.mark.parametrize("opt_name", list(OPTS))
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "deepseek-v2-236b",
                                  "grok-1-314b", "musicgen-large"])
def test_train_state_specs_equal_the_jax_packages(arch, opt_name):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    mode = jcfg.fl_mode
    name = opt_name.split("-")[0]
    jo, to = (f(None) for f in OPTS[opt_name])
    lead = 2 if mode == jfl.MODE_A else 1
    init = jfl.build_init_fn(jcfg, jo, mode=mode, n_clusters=2,
                             clients_per_cluster=2)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    kw = dict(mode=mode, opt_name=name, pod_axis="pod", tp_size=2)
    want = jfl.train_state_specs(jcfg, shapes, **kw)
    # the JAX package's abstract state in its own layout, leaf for leaf
    got = tfl.train_state_specs(tcfg, shapes, **kw)
    specs = lambda t: jax.tree.leaves(t, is_leaf=lambda x: isinstance(
        x, tuple))
    for part in ("params", "opt"):
        w = jax.tree.map(_tup, getattr(want, part),
                         is_leaf=lambda x: isinstance(x, P))
        assert specs(getattr(got, part)) == specs(w), part
    # the port's own state (meta tensors) under its names
    state = tfl.build_init_fn(tcfg, to, mode=mode, n_clusters=2,
                              clients_per_cluster=2, device="meta")()
    got = tfl.train_state_specs(tcfg, state, **kw)
    assert got.params == _spec_leaves(want.params, lead, tcfg)
    assert tuple(want.round) == got.round == ()
    if not jax.tree.leaves(shapes.opt):
        assert got.opt == () and want.opt == ()
        return
    if name == "sgd":
        assert got.opt == _spec_leaves(want.opt, lead, tcfg)
        return
    assert _tup(want.opt["t"]) == got.opt["t"] == ()
    if name == "adafactor":
        wacc = _spec_leaves(want.opt["acc"], lead, tcfg)
        gacc = _flat(got.opt["acc"])
        _known_adafactor_split(wacc, gacc, tcfg)
        for k in set(wacc) & set(gacc):
            assert gacc[k] == wacc[k], k
        return
    for k in ("m", "v"):
        assert got.opt[k] == _spec_leaves(want.opt[k], lead, tcfg)


@pytest.mark.parametrize("mode", [jfl.MODE_A, jfl.MODE_B])
@pytest.mark.parametrize("pod_axis", [None, "pod"])
def test_batch_specs_equal_the_jax_packages(mode, pod_axis):
    jcfg, tcfg = jax_smoke("musicgen-large"), get_smoke_config(
        "musicgen-large")
    lead = (2, 4, 3, 2) if mode == jfl.MODE_A else (2, 3, 4)
    batch = {"tokens": np.zeros(lead + (4, 16), np.int32),
             "labels": np.zeros(lead + (4, 16), np.int32)}
    if mode == jfl.MODE_B:
        batch["weights"] = np.zeros(lead, np.float32)
    want = jfl.batch_specs(jcfg, batch, mode=mode, pod_axis=pod_axis)
    got = tfl.batch_specs(tcfg, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                          mode=mode, pod_axis=pod_axis)
    assert got == {k: _tup(v) for k, v in want.items()}


# ---------------------------------------------------------------------- #
# the training plan at the production meshes
# ---------------------------------------------------------------------- #
def _spec(s):
    return tuple(tuple(e) if isinstance(e, list) else e for e in s)


def _placements_of(spec, names):
    out = [["R"]] * len(names)
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            out[names.index(a)] = ["S", d]
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_train_plan_equals_the_jax_packages(started_plans, mesh):
    jp, tp = started_plans["jax"].result(), started_plans["torch"].result()
    names = ("pod", "data", "model") if mesh == "2x16x16" else (
        "data", "model")
    for arch in ARCHS:
        key = f"{arch}@{mesh}"
        want, got = jp[key], tp[key]
        cfg = get_config(arch)
        lead = 2 if cfg.fl_mode == tfl.MODE_A else 1
        wrap = lambda t: jax.tree.map(
            lambda x: _Leaf(x["shape"], x["dtype"], _spec(x["spec"])), t,
            is_leaf=lambda x: isinstance(x, dict) and "shape" in x)
        wparams = _named(wrap(want["params"]), cfg, lead)
        wacc = _named(wrap(want["opt"]["acc"]), cfg, lead)
        gacc = _flat(got["opt"]["acc"])
        _known_adafactor_split(wacc, gacc, cfg)
        assert set(wparams) == set(got["params"]), key
        for w, g in ((wparams, got["params"]), (wacc, gacc)):
            for k in set(w) & set(g):
                gk = g[k]
                assert tuple(gk["shape"]) == w[k].shape, (key, k)
                assert gk["dtype"] == w[k].dtype, (key, k)
                assert _spec(gk["spec"]) == w[k].spec, (key, k)
                assert gk["placements"] == _placements_of(w[k].spec, names)
        wt, gt = want["opt"]["t"], got["opt"]["t"]
        assert (wt["shape"], _spec(wt["spec"])) == (gt["shape"],
                                                    _spec(gt["spec"]))
        for part in ("rep", "stale"):
            assert want[part]["shape"] == got[part]["shape"], (key, part)
            assert _spec(want[part]["spec"]) == _spec(got[part]["spec"])
        assert set(want["batch"]) == set(got["batch"])
        for k, w in want["batch"].items():
            g = got["batch"][k]
            assert (w["shape"], w["dtype"], _spec(w["spec"])) == (
                g["shape"], g["dtype"], _spec(g["spec"])), (key, k)
        assert got["out_is_in"]
        big = cfg.param_count() * 2 > 60e9
        assert got["options"]["accum_dtype"] == (
            "torch.bfloat16" if big else "torch.float32"), key


# ---------------------------------------------------------------------- #
# guards
# ---------------------------------------------------------------------- #
def test_a_sharded_datacenter_spec_raises_the_reference_error():
    d = {"scale": "datacenter", "task": {"kind": "lm"},
         "sharding": {"mesh": [2]}}
    with pytest.raises(ValueError) as want:
        jspec.FederationSpec.from_dict(d).validate()
    with pytest.raises(ValueError) as got:
        tspec.FederationSpec.from_dict(d).validate()
    assert str(got.value) == str(want.value)
    assert "datacenter" in str(got.value)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_serving_plans_raise_naming_the_roadmap_item(shape):
    from repro_torch.launch.plans import SHAPES, applicable, make_plan
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, queue 1, item 9"):
        make_plan("gemma-2b", shape, None)
    assert SHAPES[shape]["kind"] in ("prefill", "decode")
    from repro.launch.plans import applicable as japplicable
    for arch in ARCHS:
        assert applicable(arch, shape) == japplicable(arch, shape)


def test_the_new_modules_import_no_jax():
    code = ("import sys\n"
            "import repro_torch.core.sharding, repro_torch.launch.mesh\n"
            "import repro_torch.launch.plans, repro_torch.core.fl_step\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


# ---------------------------------------------------------------------- #
# the 30B+ plans' options, run: a bfloat16 gradient buffer and Adafactor
# computing in bfloat16
# ---------------------------------------------------------------------- #
BF16_TOL = 2 ** -6      # of a leaf's largest change: four bfloat16 ulps
BF16_LOSS_TOL = 1e-5    # the loss is float32, before any update


@pytest.mark.parametrize("mode", [jfl.MODE_A, jfl.MODE_B])
def test_bfloat16_buffer_and_adafactor_match_the_jax_step(mode):
    """One step of recurrentgemma-2b's smoke config cut to one Griffin
    period (one layer a stacked group, so the JAX package's Adafactor
    factors the same leaves as the port's), 2 microbatches whose gradients
    sum in bfloat16, Adafactor with ``compute_dtype`` bfloat16, against
    the JAX package's jitted ``build_train_step`` with the same options:
    each parameter's change within a few bfloat16 ulps of its leaf's
    largest change, the losses within 1e-5."""
    import dataclasses
    NC, C, n_micro, bm, seq = 2, 2, 2, 1, 32
    jcfg = dataclasses.replace(jax_smoke("recurrentgemma-2b"), num_layers=3)
    tcfg = dataclasses.replace(get_smoke_config("recurrentgemma-2b"),
                               num_layers=3)
    jo = jopt.adafactor(1e-2, compute_dtype=jnp.bfloat16)
    to = topt.adafactor(1e-2, compute_dtype=torch.bfloat16)
    lead = (NC, C) if mode == jfl.MODE_A else (NC,)
    js = jfl.build_init_fn(jcfg, jo, mode=mode, n_clusters=NC,
                           clients_per_cluster=C)(jax.random.PRNGKey(2))
    g = np.random.default_rng(2)
    toks = g.integers(0, jcfg.vocab_size, lead + (n_micro, bm, seq + 1))
    batch = {"tokens": toks[..., :-1].astype(np.int32),
             "labels": toks[..., 1:].astype(np.int32)}
    if mode == jfl.MODE_B:
        batch["weights"] = (g.random((NC, n_micro, bm)) + 0.5).astype(
            np.float32)
    rep = (g.random((NC, C)) + 0.1).astype(np.float32)
    stale = np.asarray([0.0, 2.0], np.float32)
    before = named_from_tree(jax.tree.map(np.asarray, js.params), tcfg,
                             len(lead))
    step = jax.jit(jfl.build_train_step(jcfg, jo, mode=mode,
                                        accum_dtype=jnp.bfloat16))
    jout, jm = step(js, jax.tree.map(jnp.asarray, batch), jnp.asarray(rep),
                    jnp.asarray(stale))
    want = named_from_tree(jax.tree.map(np.asarray, jout.params), tcfg,
                           len(lead))
    params = {k: torch.from_numpy(v.copy()) for k, v in before.items()}
    one = {k: v[(0,) * len(lead)] for k, v in params.items()}
    opt_state = tfl._map_tensors(
        to.init(one), lambda x: x.expand(lead + tuple(x.shape)).clone())
    tstep = tfl.build_train_step(tcfg, to, mode=mode,
                                 accum_dtype=torch.bfloat16)
    out, tm = tstep(tfl.TrainState(params, opt_state, 0),
                    {k: torch.from_numpy(np.asarray(
                        v, np.int64 if k != "weights" else np.float32))
                     for k, v in batch.items()},
                    torch.from_numpy(rep), torch.from_numpy(stale))
    errs = {}
    for k, w in want.items():
        dw = w.astype(np.float64) - before[k]
        dg = out.params[k].double().numpy() - before[k]
        errs[k] = float(np.abs(dg - dw).max() / (np.abs(dw).max() + 1e-30))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= BF16_TOL, (worst, errs[worst])
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=BF16_LOSS_TOL)
