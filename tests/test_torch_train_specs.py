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
  package's error, the prefill and decode plans are built, and the new
  modules import no JAX.
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
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)
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
from repro_torch.models.transformer import (LM, layer_groups,  # noqa
                                            named_from_tree, param_specs)

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


class _Whole(_Leaf):
    """A stacked 1-D group's Adafactor column (n,): every layer holds it
    whole, so a layer's index leaves it as it is."""

    def __getitem__(self, idx):
        return self


def _group_columns(tree, lead):
    """An Adafactor ``acc`` tree of `_Leaf`s (JAX layout) whose stacked
    1-D groups' columns index as `_Whole`."""
    def walk(node):
        if isinstance(node, dict) and set(node) == {"r", "c"}:
            r, c = node["r"], node["c"]
            if len(r.shape) == lead + 1:
                return dict(node, c=_Whole(c.shape, c.dtype, c.spec))
            return node
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node
    return dict(tree, groups=[walk(g) for g in tree["groups"]])


def _spec_leaves(tree, lead, cfg):
    wrap = jax.tree.map(lambda p: _Leaf((0,) * len(p), spec=_tup(p)), tree,
                        is_leaf=lambda x: isinstance(x, P))
    if isinstance(wrap.get("embed"), dict):        # Adafactor's acc
        wrap = _group_columns(wrap, lead)
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
        assert _flat(got.opt["acc"]) == _spec_leaves(want.opt["acc"], lead,
                                                     tcfg)
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
        wacc = _named(_group_columns(wrap(want["opt"]["acc"]), lead), cfg,
                      lead)
        gacc = _flat(got["opt"]["acc"])
        assert set(wparams) == set(got["params"]), key
        assert set(wacc) == set(gacc), key
        for w, g in ((wparams, got["params"]), (wacc, gacc)):
            for k in w:
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
    """The serving plans, which raised naming ROADMAP.md's item 9 until
    they were ported, are built for every serving shape (held to the JAX
    package's in ``tests/test_torch_serve_specs.py``), with the JAX
    package's ``applicable`` for every architecture."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.plans import SHAPES, applicable, make_plan
    plan = make_plan("gemma-2b", shape, make_host_mesh(1, 1, device="cpu"))
    assert plan.kind == SHAPES[shape]["kind"] in ("prefill", "decode")
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
    period (one layer a stacked group), 2 microbatches whose gradients
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
        to.init(one, groups=layer_groups(tcfg, one)),
        lambda x: x.expand(lead + tuple(x.shape)).clone())
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


# ---------------------------------------------------------------------- #
# Adafactor on the JAX package's stacked layer groups
# ---------------------------------------------------------------------- #
GROUP_TOL = 1e-5        # of a leaf's largest entry; and the losses
MOMENT_RTOL = 1e-6




def _linear_losses(params, lead, scale_layer):
    """A loss linear in the parameters, sum(p * coef), in each package:
    its gradient is ``coef`` exactly in both, the layer ``scale_layer``'s
    coefficients 1e-3 of the others'."""
    g = np.random.default_rng(7)
    coef = jax.tree.map(lambda a: g.standard_normal(
        a.shape[len(lead):]).astype(np.float32), params)
    for sub in coef["groups"]:
        for leaf in jax.tree.leaves(sub):
            leaf[scale_layer] *= 1e-3
    jc = jax.tree.map(jnp.asarray, coef)
    tc = {k: torch.from_numpy(v) for k, v in named_from_tree(
        coef, GROUP_CFG[1]).items()}

    def jloss(p, mb):
        return sum(jnp.sum(a * c) for a, c in zip(jax.tree.leaves(p),
                                                  jax.tree.leaves(jc)))

    def tloss(p, mb):
        return sum(torch.sum(p[k] * tc[k]) for k in p)
    return jloss, tloss


GROUP_CFG = tuple(__import__("dataclasses").replace(f("gemma-7b"),
                                                    num_layers=2)
                  for f in (jax_smoke, get_smoke_config))


@pytest.mark.parametrize("loss", ["lm", "linear"])
def test_adafactor_updates_a_stacked_group_as_the_jax_package(loss):
    """One mode-A Adafactor step of gemma-7b's smoke config at 2 layers
    (pattern ('attn',): each leaf a group of G = 2) whose layers'
    gradients are ~1e3 apart, against the JAX package's jitted
    ``build_train_step``: the update is clipped over each group and a 1-D
    group's moments are the stack's rows (G,) and columns (n,).  Each
    parameter within 1e-5 of its leaf's largest entry and the losses
    within 1e-5; the moments, carried over by `train_state_to_numpy`, to
    1e-6 relative where both packages get the same gradients.

    ``lm``: the LM loss, the second layer's ``wo`` and ``wd`` scaled by
    1e-3 (its other leaves' gradients fall ~1e3); its float32 gradients
    differ between the packages by ~1e-4 relative in their smallest
    entries, and a 1-D group's column (a squared gradient) carries that,
    so the moments are held to their layout there.  ``linear``: a loss
    linear in the parameters, whose gradient is the same in both, the
    second layer's 1e-3 of the first's."""
    NC, C, n_micro, bm, seq = 1, 2, 1, 2, 16
    jcfg, tcfg = GROUP_CFG
    mode, lead = jfl.MODE_A, (NC, C)
    assert tuple(jcfg.block_pattern) == ("attn",)
    jo, to = jopt.adafactor(1e-2), topt.adafactor(1e-2)
    js = jfl.build_init_fn(jcfg, jo, mode=mode, n_clusters=NC,
                           clients_per_cluster=C)(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, js.params)
    jloss = tloss = None
    if loss == "lm":
        for part, leaf in (("attn", "wo"), ("mlp", "wd")):
            w = np.array(params["groups"][0][part][leaf])
            w[:, :, 1] *= 1e-3
            params["groups"][0][part][leaf] = w
        js = js._replace(params=jax.tree.map(jnp.asarray, params))
    else:
        jloss, tloss = _linear_losses(params, lead, 1)
    g = np.random.default_rng(3)
    toks = g.integers(0, jcfg.vocab_size, lead + (n_micro, bm, seq + 1))
    batch = {"tokens": toks[..., :-1].astype(np.int32),
             "labels": toks[..., 1:].astype(np.int32)}
    rep = (g.random(lead) + 0.1).astype(np.float32)
    stale = np.zeros((NC,), np.float32)
    jout, jm = jax.jit(jfl.build_train_step(jcfg, jo, mode=mode,
                                            loss_fn=jloss))(
        js, jax.tree.map(jnp.asarray, batch), jnp.asarray(rep),
        jnp.asarray(stale))

    before = named_from_tree(params, tcfg, len(lead))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in before.items()}
    one = {k: v[(0,) * len(lead)] for k, v in tp.items()}
    groups = layer_groups(tcfg, one)
    assert groups and all(len(grp) == 2 for grp in groups)
    opt_state = tfl._map_tensors(
        to.init(one, groups=groups),
        lambda x: x.expand(lead + tuple(x.shape)).clone())
    out, tm = tfl.build_train_step(tcfg, to, mode=mode, loss_fn=tloss)(
        tfl.TrainState(tp, opt_state, 0),
        {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()},
        torch.from_numpy(rep), torch.from_numpy(stale))

    want = named_from_tree(jax.tree.map(np.asarray, jout.params), tcfg,
                           len(lead))
    errs = {k: float(np.abs(out.params[k].numpy() - w).max()
                     / np.abs(w).max()) for k, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GROUP_TOL, (worst, errs[worst])
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=GROUP_TOL)
    # the moments, in the JAX package's layout
    jacc = jax.tree.map(np.asarray, jout.opt["acc"])
    tacc = tfl.train_state_to_numpy(out, tcfg, mode=mode)["opt"]["acc"]
    flat = lambda t: {jax.tree_util.keystr(p): v for p, v in   # noqa
                      jax.tree_util.tree_leaves_with_path(t)}
    fj, ft = flat(jacc), flat(tacc)
    assert set(fj) == set(ft)
    vectors = [k for k in fj if k.startswith("['groups'][0]")
               and k.endswith("['r']") and fj[k].ndim == len(lead) + 1]
    assert len(vectors) == 2                          # ln1, ln2: rows (G,)
    for k in vectors:
        col = k[:-len("['r']")] + "['c']"
        assert fj[col].shape == ft[col].shape == lead + (
            jcfg.d_model,), col                           # columns (n,)
    for k in fj:
        assert fj[k].shape == ft[k].shape, k
        if loss == "linear":
            np.testing.assert_allclose(ft[k], fj[k], rtol=MOMENT_RTOL,
                                       err_msg=k)
