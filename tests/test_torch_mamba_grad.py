"""Gradients of the port's selective scan and Mamba layers against the JAX
package's.

The JAX package has no backward kernel: its training differentiates the
``lax.scan`` of ``mamba_forward``.  Here, on numpy inputs drawn from seeds:

* the plain backward (`repro_torch.kernels.ref.selective_scan_bwd_ref`)
  against ``torch.autograd`` of the plain forward and ``jax.vjp`` of the
  JAX package's ``selective_scan_ref``, with d h_last zero, absent and
  non-zero, and the wrapper's `torch.autograd.Function` on the CPU;
* the numerics of ``csrc/selective_scan_bwd.cu`` emulated on the CPU (the
  exp2 decay, the fused updates, the pairwise sums over a warp's channels
  and a channel's lanes, the warps' and blocks' partials summed in order)
  against the plain backward; the backward's blocks; the forward's chunk
  states (`ref.selective_scan_chunk_states_ref`) against the JAX
  package's ``selective_scan_ref`` on prefixes; which forwards keep chunk
  states under a layer checkpoint;
* a MAMBA layer's gradients (every parameter) against ``jax.vjp`` of the
  JAX package's ``mamba_forward``;
* one mode-A and one mode-B federated step of falcon-mamba-7b's smoke
  config against the JAX package's ``fl_step``;
* `cuda`-marked twins: the backward kernel against the plain backward on
  the card, the forward's states output (its outputs bit for bit those
  without it), the launches of a direct backward call and of a
  checkpointed layer, and a MAMBA layer's gradients through both
  kernels.

The falcon-mamba smoke config's `lm_loss` value and gradient against the
JAX package's is a case of ``tests/test_torch_lm_grad.py``'s ``LM_CASES``.

Tolerances: the backward formulas against autograd or ``jax.vjp`` of the
same forward, FORMULA_TOL = 2e-5 relative to each gradient's largest entry
(float32 sums in another order); the kernel's numerics and the kernel on
the card against the plain backward, BWD_TOL = 1e-4 of each gradient's
largest entry (its sums over channels pairwise and over blocks, on FMAs,
and exp2 in place of exp); a layer's gradients 1e-4 of
each leaf's largest entry; a federated step 1e-5 of each leaf's largest entry, the
losses 1e-5 relative (as ``tests/test_torch_train.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import fl_step as tfl  # noqa: E402
from repro_torch.kernels import (launches, ref,  # noqa: E402
                                 reset_launches, selective_scan,
                                 selective_scan_bwd, state_launches)
from repro_torch.kernels.selective_scan import (  # noqa: E402
    BWD_STATES, bwd_channels, bwd_lanes, bwd_scratch_floats)
from repro_torch.models.mamba import mamba_forward  # noqa: E402
from repro_torch import optim as topt  # noqa: E402

try:            # the card's machine has no JAX: only the cuda tests run
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core import fl_step as jfl
    from repro.kernels import ref as jax_ref
    from repro.models.mamba import init_mamba as jax_init_mamba
    from repro.models.mamba import mamba_forward as jax_mamba_forward
    from repro.optim import optimizers as jopt
except ImportError:
    jax = None

ARCH = "falcon-mamba-7b"
FORMULA_TOL = 2e-5
BWD_TOL = 1e-4
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.fixture(scope="module")
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def _rel(got, want):
    got = np.asarray(got.detach() if hasattr(got, "detach") else got,
                     np.float64)
    want = np.asarray(want.detach() if hasattr(want, "detach") else want,
                      np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want), initial=0.0)
                 / (np.max(np.abs(want), initial=0.0) + 1e-30))


def _scan_case(B, S, Di, N, seed, dt_scale=1.0):
    """tests/test_kernels.py's selective-scan draws (xc, softplus(normal)
    dt, Bc and Cc at scale 0.5, A = -exp(normal)), with dt scaled by
    ``dt_scale``, then dy and d h_last."""
    g = np.random.default_rng(seed)
    xc = (g.standard_normal((B, S, Di)) * 0.5).astype(np.float32)
    dt = (np.log1p(np.exp(g.standard_normal((B, S, Di)))) * dt_scale
          ).astype(np.float32)
    Bc = (g.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cc = (g.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    A = -np.exp(g.standard_normal((Di, N))).astype(np.float32)
    dy = g.standard_normal((B, S, Di)).astype(np.float32)
    dh = g.standard_normal((B, Di, N)).astype(np.float32)
    return xc, dt, Bc, Cc, A, dy, dh


# (B, S, Di, N, dt scale): ragged S across the kernel's chunks of 32,
# Di not a multiple of its 64 channels a block, N = 4 and 8, B = 1-3, and
# a dt large enough that exp(dt A) underflows to 0 in float32
SCAN_CASES = [(2, 33, 24, 8, 1.0), (1, 64, 32, 4, 1.0), (3, 1, 5, 8, 1.0),
              (1, 40, 16, 8, 300.0)]


@pytest.mark.parametrize("dh", ["zero", "none", "random"])
@pytest.mark.parametrize("B,S,Di,N,dt_scale", SCAN_CASES)
def test_selective_scan_backward_matches_autograd_and_jax(
        needs_jax, B, S, Di, N, dt_scale, dh):
    xc, dt, Bc, Cc, A, dy, dh_np = _scan_case(B, S, Di, N, seed=S + Di,
                                              dt_scale=dt_scale)
    if dh != "random":
        dh_np = np.zeros_like(dh_np)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (xc, dt, Bc, Cc,
                                                              A)]
    tdy, tdh = torch.from_numpy(dy), torch.from_numpy(dh_np)
    # autograd of the plain forward
    y, h = ref.selective_scan_ref(*leaves)
    want = torch.autograd.grad((y, h), leaves, (tdy, tdh))
    # the plain backward by its formulas (None: no gradient reaches h_last)
    plain = [x.detach() for x in leaves]
    got = ref.selective_scan_bwd_ref(*plain, tdy,
                                     None if dh == "none" else tdh)
    # the wrapper's autograd.Function on the CPU
    y2, h2 = selective_scan(*leaves)
    fn = torch.autograd.grad((y2, h2) if dh == "random" else y2, leaves,
                             (tdy, tdh) if dh == "random" else tdy)
    # jax.vjp of the JAX package's plain scan
    _, vjp = jax.vjp(jax.jit(jax_ref.selective_scan_ref),
                     *(jnp.asarray(x) for x in (xc, dt, Bc, Cc, A)))
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(dh_np)))
    if dt_scale > 1.0:      # the decays underflow: exp(dt A) is 0 somewhere
        assert float(torch.exp(plain[1][..., None] * plain[4]).min()) == 0.0
    for name, g_, w_, f_, j_ in zip(("xc", "dt", "Bc", "Cc", "A"), got, want,
                                    fn, jgrads):
        assert _rel(g_, w_) < FORMULA_TOL, name
        assert _rel(g_, j_) < FORMULA_TOL, name
        assert _rel(f_, g_) == 0.0, name


def test_selective_scan_backward_wrapper_takes_the_plain_version_on_cpu():
    args = [torch.from_numpy(x) for x in _scan_case(2, 9, 12, 8, seed=0)]
    before = dict(launches)
    got = selective_scan_bwd(*args)
    want = ref.selective_scan_bwd_ref(*args)
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
    assert launches == before


# --------------------------------------------------------------------- #
# the kernel's numerics, emulated
# --------------------------------------------------------------------- #
def _fma(a, b, c):
    """a b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def _halving(v, dim):
    """Sum over ``dim`` (a power of two long) pairwise, the first half
    plus the second each round: the order of the kernel's halving and
    butterfly shuffles (lanes paired on their highest bit first)."""
    while v.shape[dim] > 1:
        half = v.shape[dim] // 2
        v = v.narrow(dim, 0, half) + v.narrow(dim, half, half)
    return v.squeeze(dim)


def _in_order(parts):
    """Sum of a sequence of tensors from 0, one after another."""
    s = torch.zeros_like(parts[0])
    for p in parts:
        s = s + p
    return s


def _scan_bwd_kernel_numerics(xc, dt, Bc, Cc, A, dy, dh_last):
    """csrc/selective_scan_bwd.cu's arithmetic in float32 on the CPU: the
    states as the forward kernel computes them (dA = exp2(dt a2), a2 = A
    log2 e rounded to f32, one FMA an update; S padded to whole 32-step
    chunks with dt = dy = 0); g entering the last step as d h_last, then
    each step back g = fma(dA_{t+1}, g, dy C); a lane's `BWD_STATES`
    states summed by FMAs, then its channel's L lanes pairwise; the dBc
    and dCc terms summed over a warp's 32 / L channels pairwise, then the
    warps of a block, then the blocks in order; dA over the steps backward
    by FMAs, then over b in order."""
    B, S, Di = xc.shape
    N = A.shape[1]
    K, lanes = BWD_STATES, bwd_lanes(N)
    width, channels = K * lanes, bwd_channels(N)
    warps = channels * lanes // 32
    per_warp = 32 // lanes
    blocks = -(-Di // channels)
    D = blocks * channels
    T = -(-S // 32) * 32
    pad = lambda t, w: torch.nn.functional.pad(t, (0, w - t.shape[-1], 0,
                                                   T - t.shape[1]))
    x, d, gy = (pad(t, D) for t in (xc, dt, dy))
    b, c = pad(Bc, width), pad(Cc, width)
    a2 = torch.nn.functional.pad(A * np.float32(LOG2E),
                                 (0, width - N, 0, D - Di))
    # the states: hs[t + 1] = h_t, hs[0] = h_{-1} = 0
    h = torch.zeros((B, D, width))
    hs, das = [h], []
    for t in range(T):
        da = torch.exp2(d[:, t, :, None] * a2)
        h = _fma(da, h, (d[:, t] * x[:, t])[..., None] * b[:, t, None, :])
        hs.append(h)
        das.append(da)
    g = torch.zeros((B, D, width))
    if dh_last is not None:
        g[:, :Di, :N] = dh_last
    dan = torch.ones((B, D, width))
    dacc = torch.zeros((B, D, width))
    dx, ddt = torch.empty((B, T, D)), torch.empty((B, T, D))
    dbc = torch.empty((B, T, 2, width))
    for t in range(T - 1, -1, -1):
        dtv, xv, dyv = d[:, t, :, None], x[:, t, :, None], gy[:, t, :, None]
        dtx = dtv * xv
        da, hp = das[t], hs[t]
        g = _fma(dan, g, dyv * c[:, t, None, :])
        terms = torch.stack([g * dtx, dyv * hs[t + 1]], 2)
        warp = _halving(terms.reshape(B, blocks, warps, per_warp, 2, width),
                        3)
        dbc[:, t] = _in_order(_in_order(warp.unbind(2)).unbind(1))
        u = g * da * hp
        gb = torch.zeros((B, D, lanes))
        s2 = torch.zeros((B, D, lanes))
        for r in range(K):
            gb = _fma(g[..., r::K], b[:, t, None, r::K], gb)
            s2 = _fma(a2[:, r::K], u[..., r::K], s2)
        sgb, ss2 = _halving(gb, 2), _halving(s2, 2)
        dx[:, t] = dtv[..., 0] * sgb
        ddt[:, t] = _fma(xv[..., 0], sgb, ss2 * np.float32(LN2))
        dacc = _fma(u, dtv, dacc)
        dan = da
    dA = _in_order(dacc.unbind(0))
    return (dx[:, :S, :Di], ddt[:, :S, :Di], dbc[:, :S, 0, :N],
            dbc[:, :S, 1, :N], dA[:Di, :N])


# (B, S, Di, N, dt scale) beyond SCAN_CASES: Di = 130 spans three blocks of
# 64 channels; S = 200 seven chunks with decays that underflow; N = 33
# sixteen lanes a channel (16 channels a block) over four chunks
KERNEL_CASES = SCAN_CASES + [(1, 37, 130, 16, 1.0), (1, 200, 40, 16, 300.0),
                             (2, 100, 20, 33, 1.0)]


@pytest.mark.parametrize("dh", [False, True])
@pytest.mark.parametrize("B,S,Di,N,dt_scale", KERNEL_CASES)
def test_backward_kernel_numerics_meet_the_tolerance(B, S, Di, N, dt_scale,
                                                     dh):
    """The kernel's exp2, fused updates and summation orders stay within
    BWD_TOL of each gradient's largest entry of the plain backward."""
    xc, dt, Bc, Cc, A, dy, dh_np = (torch.from_numpy(x) for x in _scan_case(
        B, S, Di, N, seed=S + Di + 1, dt_scale=dt_scale))
    dh_last = dh_np if dh else None
    got = _scan_bwd_kernel_numerics(xc, dt, Bc, Cc, A, dy, dh_last)
    want = ref.selective_scan_bwd_ref(xc, dt, Bc, Cc, A, dy, dh_last)
    for name, g_, w_ in zip(("xc", "dt", "Bc", "Cc", "A"), got, want):
        assert _rel(g_, w_) < BWD_TOL, name


def test_backward_launch_plan():
    """The backward's blocks: at falcon-mamba-7b's training shape (1, 4096,
    8192, 16) 128 blocks of 64 channels (4 lanes a channel), one an SM;
    the scratch holds the blocks' partials and each b's dA."""
    assert (bwd_lanes(16), bwd_channels(16)) == (4, 64)
    assert (bwd_lanes(4), bwd_lanes(17), bwd_lanes(64)) == (1, 8, 16)
    assert (bwd_channels(32), bwd_channels(64)) == (32, 16)
    assert bwd_scratch_floats(1, 4096, 8192, 16) == (
        128 * 4096 * 2 * 16 + 8192 * 16)
    assert bwd_scratch_floats(2, 37, 100, 16) == (
        -(-(2 * 2 * 37 * 2 * 16) // 64) * 64 + 2 * 16 * 100)


def _small_lm():
    """falcon-mamba-7b's smoke config (two MAMBA layers) at `_small` width,
    on the CPU."""
    from repro_torch.models import LM
    cfg = _small(get_smoke_config)
    assert cfg.num_layers == 2
    return LM(cfg, trainable=True)


@pytest.mark.parametrize("how", ["remat", "plain", "no_grad"])
def test_checkpoint_keeps_chunk_states_only_in_the_recompute(monkeypatch,
                                                             how):
    """Under `LM.forward(remat=True)` each MAMBA layer's first pass runs
    inside `without_chunk_states` (its saved tensors are dropped) and its
    recompute outside it, so on the card only the recompute writes the
    chunk states; without the checkpoint every forward keeps them, and
    under no_grad no scan is differentiable.  The gradients with and
    without the checkpoint are equal."""
    from repro_torch.kernels.selective_scan import (_SelectiveScan,
                                                    _keep_states)
    seen = []
    real = _SelectiveScan.forward

    def spy(ctx, *args):
        seen.append(_keep_states.get())
        return real(ctx, *args)
    monkeypatch.setattr(_SelectiveScan, "forward", staticmethod(spy))
    model = _small_lm()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 12)))
    if how == "no_grad":
        with torch.no_grad():
            model(toks, remat=True)
        assert seen == []
        return
    params = dict(model.named_parameters())
    out = model(toks, remat=how == "remat")
    grads = torch.autograd.grad(out.square().mean(), list(params.values()))
    if how == "remat":
        assert seen == [False, False, True, True]
        want = torch.autograd.grad(model(toks).square().mean(),
                                   list(params.values()))
        assert all(torch.equal(g_, w_) for g_, w_ in zip(grads, want))
    else:
        assert seen == [True, True]


@pytest.mark.parametrize("N", [16, 17])
def test_chunk_states_match_jax_prefixes(needs_jax, N):
    """`selective_scan_chunk_states_ref`'s state entering chunk k (the
    forward kernel's states output) against the JAX package's
    ``selective_scan_ref`` h_last over the first 32 k steps; chunk 0's is
    zero."""
    S, Di = 100, 130
    xc, dt, Bc, Cc, A, _, _ = _scan_case(1, S, Di, N, seed=N)
    got = ref.selective_scan_chunk_states_ref(
        *(torch.from_numpy(x) for x in (xc, dt, Bc, Cc, A)))
    assert got.shape == (4, 1, N, Di)
    assert float(got[0].abs().max()) == 0.0
    for k in range(1, 4):
        _, h = jax.jit(jax_ref.selective_scan_ref)(
            *(jnp.asarray(x[:, :32 * k]) for x in (xc, dt, Bc, Cc)),
            jnp.asarray(A))
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(h).transpose(0, 2, 1),
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# a MAMBA layer, and the federated step
# --------------------------------------------------------------------- #
def _small(get):
    """falcon-mamba-7b's smoke config at d_model 16 (Di 32), N 8."""
    return dataclasses.replace(get(ARCH), d_model=16, dt_rank=4,
                               ssm_state=8)


def _layer_case(seed=5, B=2, S=12):
    cfg = _small(jax_smoke_config)
    p = jax.tree.map(np.asarray, jax_init_mamba(jax.random.PRNGKey(1), cfg))
    g = np.random.default_rng(seed)
    # a learned-looking A and non-zero biases, so every term is exercised
    p = {**p, "A_log": (p["A_log"] + g.standard_normal(p["A_log"].shape)
                        * 0.3).astype(np.float32),
         "conv_b": (g.standard_normal(p["conv_b"].shape) * 0.1
                    ).astype(np.float32),
         "dt_bias": (g.standard_normal(p["dt_bias"].shape) * 0.1
                     ).astype(np.float32)}
    x = g.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    dy = g.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return cfg, p, x, dy


def _torch_layer_grads(p, x, dy, device="cpu"):
    tp = {k: torch.from_numpy(v.copy()).to(device).requires_grad_()
          for k, v in p.items()}
    tx = torch.from_numpy(x).to(device).requires_grad_()
    ty = mamba_forward(tp, _small(get_smoke_config), tx)
    grads = torch.autograd.grad(ty, [tx] + list(tp.values()),
                                torch.from_numpy(dy).to(device))
    return ty, grads[0], dict(zip(tp, grads[1:]))


def test_mamba_layer_gradients_match_jax(needs_jax):
    """The whole Mamba block (in_proj, conv, x_proj, dt_proj, softplus, the
    scan through the wrapper's plain backward, D, the gate, out_proj)
    against ``jax.vjp`` of the JAX package's ``mamba_forward``: the input
    and every parameter, A_log through A = -exp(A_log)."""
    cfg, p, x, dy = _layer_case()

    @jax.jit
    def jax_vjp(pp, xx, dd):
        y_, vjp = jax.vjp(lambda p_, x_: jax_mamba_forward(p_, cfg, x_),
                          pp, xx)
        return y_, vjp(dd)
    jy, (jp, jx) = jax_vjp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                           jnp.asarray(dy))
    ty, gx, gp = _torch_layer_grads(p, x, dy)
    assert set(gp) == {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                       "dt_bias", "A_log", "D", "out_proj"}
    assert _rel(ty, jy) < 1e-5
    assert _rel(gx, jx) < 1e-4
    for k, gr in gp.items():
        assert float(gr.abs().max()) > 0.0, k
        assert _rel(gr, jp[k]) < 1e-4, k


NC, C, N_MICRO, BM, SEQ = 2, 2, 2, 1, 8
LOCAL_STEPS = {tfl.MODE_A: 2, tfl.MODE_B: 1}


def _max_rel(got, want):
    """Largest `_rel` over the leaves of two nested trees."""
    if isinstance(want, dict):
        return max([_max_rel(got[k], want[k]) for k in want], default=0.0)
    if isinstance(want, (list, tuple)):
        return max([_max_rel(g, w) for g, w in zip(got, want)], default=0.0)
    return _rel(got, want)


def _step_pair(mode, seed):
    """One JAX step of falcon-mamba-7b's smoke config (2 MAMBA layers) on
    perturbed parameters, Adam moments of a few steps and a token batch,
    then the port's step on the same numpy state."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    opt = jopt.adam(3e-4)
    fresh = jfl.build_init_fn(jcfg, opt, mode=mode, n_clusters=NC,
                              clients_per_cluster=C)(
                                  jax.random.PRNGKey(seed))
    g = np.random.default_rng(seed)
    pert = lambda x: (np.asarray(x) + g.standard_normal(x.shape) * 0.01
                      ).astype(np.float32)
    lead = (NC, C) if mode == tfl.MODE_A else (NC,)
    state = {"params": jax.tree.map(pert, fresh.params),
             "opt": {"m": jax.tree.map(lambda x: (g.standard_normal(
                 x.shape) * 1e-3).astype(np.float32), fresh.params),
                     "v": jax.tree.map(lambda x: (g.random(x.shape) * 1e-5
                                                  ).astype(np.float32),
                                       fresh.params),
                     "t": np.full(lead, 3, np.int32)},
             "round": 0}
    toks = g.integers(0, jcfg.vocab_size, lead + (N_MICRO, BM, SEQ + 1))
    batch = {"tokens": toks[..., :-1].astype(np.int32),
             "labels": toks[..., 1:].astype(np.int32)}
    if mode == tfl.MODE_B:
        batch["weights"] = (g.random((NC, N_MICRO, BM)) + 0.5
                            ).astype(np.float32)
    rep = (g.random((NC, C)) + 0.1).astype(np.float32)
    stale = np.asarray([0.0, 2.0], np.float32)
    js = jfl.TrainState(jax.tree.map(jnp.asarray, state["params"]),
                        jax.tree.map(jnp.asarray, state["opt"]),
                        jnp.zeros((), jnp.int32))
    jstep = jax.jit(jfl.build_train_step(jcfg, opt, mode=mode,
                                         local_steps=LOCAL_STEPS[mode]))
    jout, jm = jstep(js, jax.tree.map(jnp.asarray, batch), jnp.asarray(rep),
                     jnp.asarray(stale))
    ts = tfl.train_state_from_numpy(state, tcfg, mode=mode, device="cpu")
    tb = {k: torch.from_numpy(np.asarray(v, np.int64 if k != "weights"
                                         else np.float32))
          for k, v in batch.items()}
    tstep = tfl.build_train_step(tcfg, topt.adam(3e-4), mode=mode,
                                 local_steps=LOCAL_STEPS[mode])
    tout, tm = tstep(ts, tb, torch.from_numpy(rep), torch.from_numpy(stale))
    got = tfl.train_state_to_numpy(tout, tcfg, mode=mode)
    want = {"params": jax.tree.map(np.asarray, jout.params),
            "opt": jax.tree.map(np.asarray, jout.opt)}
    return got, tm, want, {k: np.asarray(v) for k, v in jm.items()}


@pytest.mark.parametrize("mode", [tfl.MODE_A, tfl.MODE_B])
def test_mamba_federated_step_matches_the_jax_package(needs_jax, mode):
    """Mode A (a = 2 local Adam steps of 2 microbatches, NC 2 x C 2) and
    mode B (trust-weighted loss, a = 1, NC 2) of falcon-mamba-7b's smoke
    config: parameters, Adam m, v and t, and the loss."""
    got, tm, want, jm = _step_pair(mode, seed=3 if mode == tfl.MODE_A
                                   else 4)
    assert _max_rel(got["params"], want["params"]) < 1e-5
    assert _max_rel(got["opt"]["m"], want["opt"]["m"]) < 1e-5
    assert _max_rel(got["opt"]["v"], want["opt"]["v"]) < 1e-5
    np.testing.assert_array_equal(got["opt"]["t"], want["opt"]["t"])
    np.testing.assert_allclose(tm["loss"].numpy(), jm["loss"], rtol=1e-5)
    if mode == tfl.MODE_A:
        np.testing.assert_allclose(tm["trust_weights"].numpy(),
                                   jm["trust_weights"], rtol=1e-6)


# --------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------- #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Di,N,dt_scale", SCAN_CASES + [
    (1, 4096, 8192, 16, 1.0), (2, 31, 130, 16, 1.0), (1, 4097, 100, 16, 1.0),
    (3, 33, 72, 64, 1.0), (2, 50, 64, 17, 1.0), (1, 65, 96, 32, 300.0),
    (2, 1000, 96, 16, 300.0)])
def test_cuda_selective_scan_gradient_matches_plain_backward(B, S, Di, N,
                                                             dt_scale):
    """Through the autograd Function on the card: the forward (writing its
    chunk states) and the backward kernel given them, one launch each,
    every gradient within BWD_TOL of its largest entry of the plain
    backward; d h_last zero or not; two calls of the backward bit for bit
    equal.  (2, 1000, 96, 16) walks 32 chunks with decays that
    underflow."""
    dev = _card()
    xc, dt, Bc, Cc, A, dy, dh = (torch.from_numpy(x).to(dev) for x in
                                 _scan_case(B, S, Di, N, seed=S + Di,
                                            dt_scale=dt_scale))
    for with_dh in (False, True):
        leaves = [t.clone().requires_grad_() for t in (xc, dt, Bc, Cc, A)]
        reset_launches()
        y, h = selective_scan(*leaves)
        outs, cots = ((y, h), (dy, dh)) if with_dh else (y, dy)
        got = torch.autograd.grad(outs, leaves, cots)
        torch.cuda.synchronize()
        assert launches["selective_scan"] == 1
        assert launches["selective_scan_bwd"] == 1
        want = ref.selective_scan_bwd_ref(xc, dt, Bc, Cc, A, dy,
                                          dh if with_dh else None)
        for name, g_, w_ in zip(("xc", "dt", "Bc", "Cc", "A"), got, want):
            assert _rel(g_.cpu(), w_.cpu()) < BWD_TOL, (name, with_dh)
    again = selective_scan_bwd(xc, dt, Bc, Cc, A, dy, dh)
    first = selective_scan_bwd(xc, dt, Bc, Cc, A, dy, dh)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(again, first))
    with pytest.raises(TypeError, match="float32"):
        selective_scan(xc.bfloat16().requires_grad_(), dt.bfloat16(),
                       Bc.bfloat16(), Cc.bfloat16(), A)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Di,N", [(4, 4096, 8192, 16), (2, 70, 100, 17),
                                      (1, 33, 64, 64), (3, 5, 3, 5)])
def test_cuda_forward_states_leave_the_outputs_bit_for_bit(B, S, Di, N):
    """The forward with its states output gives y and h_last bit for bit
    those of the forward without it (serving's call), and states within
    atol 1e-5 (rtol 0.05) of `selective_scan_chunk_states_ref`."""
    dev = _card()
    from repro_torch.kernels.selective_scan import _forward
    xc, dt, Bc, Cc, A, _, _ = (torch.from_numpy(x).to(dev) for x in
                               _scan_case(B, S, Di, N, seed=S + N))
    y0, h0 = _forward(xc, dt, Bc, Cc, A)
    y1, h1, states = _forward(xc, dt, Bc, Cc, A, states=True)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    want = ref.selective_scan_chunk_states_ref(xc, dt, Bc, Cc, A)
    torch.testing.assert_close(states, want, atol=1e-5, rtol=0.05)


@pytest.mark.cuda
def test_cuda_backward_counts_its_forward_without_states():
    """A direct `selective_scan_bwd` call without chunk states launches the
    forward kernel for them (one `selective_scan` launch) and the backward;
    given the states, the backward alone, with the same bits, within
    BWD_TOL (3 blocks of 64 channels, 10 chunks)."""
    dev = _card()
    from repro_torch.kernels.selective_scan import _forward
    xc, dt, Bc, Cc, A, dy, dh = (torch.from_numpy(x).to(dev) for x in
                                 _scan_case(1, 300, 130, 16, seed=11))
    reset_launches()
    got = selective_scan_bwd(xc, dt, Bc, Cc, A, dy, dh)
    torch.cuda.synchronize()
    assert launches["selective_scan"] == 1
    assert launches["selective_scan_bwd"] == 1
    states = _forward(xc, dt, Bc, Cc, A, states=True)[2]
    reset_launches()
    again = selective_scan_bwd(xc, dt, Bc, Cc, A, dy, dh, states)
    torch.cuda.synchronize()
    assert launches["selective_scan"] == 0
    assert launches["selective_scan_bwd"] == 1
    assert all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
    want = ref.selective_scan_bwd_ref(xc, dt, Bc, Cc, A, dy, dh)
    for name, g_, w_ in zip(("xc", "dt", "Bc", "Cc", "A"), again, want):
        assert _rel(g_.cpu(), w_.cpu()) < BWD_TOL, name


@pytest.mark.cuda
def test_cuda_mamba_layer_gradients_match_the_cpu():
    """A MAMBA layer on the card (both scan kernels) against the same
    layer on the CPU (the plain versions): the input and every parameter
    within 1e-4 of its largest entry."""
    dev = _card()
    cfg = _small(get_smoke_config)
    g = np.random.default_rng(9)
    from repro_torch.models.mamba import init_mamba
    p = {k: v.numpy() for k, v in init_mamba(
        cfg, torch.Generator().manual_seed(1)).items()}
    p["A_log"] = (p["A_log"] + g.standard_normal(p["A_log"].shape) * 0.3
                  ).astype(np.float32)
    x = g.standard_normal((2, 70, cfg.d_model)).astype(np.float32)
    dy = g.standard_normal((2, 70, cfg.d_model)).astype(np.float32)
    reset_launches()
    ty, gx, gp = _torch_layer_grads(p, x, dy, device=dev)
    torch.cuda.synchronize()
    assert launches["selective_scan"] == 1
    assert launches["selective_scan_bwd"] == 1
    cy, cx, cp = _torch_layer_grads(p, x, dy)
    assert _rel(gx.cpu(), cx) < 1e-4
    for k in cp:
        assert float(gp[k].abs().max()) > 0.0, k
        assert _rel(gp[k].cpu(), cp[k]) < 1e-4, k


@pytest.mark.cuda
def test_cuda_checkpoint_writes_the_chunk_states_once():
    """`LM.forward(remat=True)` on the card: each MAMBA layer's scan runs
    twice forward (the first pass, then the recompute) and once backward,
    and only the recompute writes chunk states (`state_launches`); the
    gradients equal those without the checkpoint bit for bit."""
    dev = _card()
    from repro_torch.models import LM
    model = LM(_small(get_smoke_config), device=dev, trainable=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.cfg.vocab_size, (2, 70))).to(dev)
    params = list(model.parameters())
    want = torch.autograd.grad(model(toks).square().mean(), params)
    reset_launches()
    state_launches["selective_scan"] = 0
    got = torch.autograd.grad(model(toks, remat=True).square().mean(),
                              params)
    torch.cuda.synchronize()
    assert launches["selective_scan"] == 4
    assert state_launches["selective_scan"] == 2
    assert launches["selective_scan_bwd"] == 2
    assert all(torch.equal(g_, w_) for g_, w_ in zip(got, want))


def test_train_cli_runs_falcon_mamba_on_the_cpu(capsys):
    """``python -m repro_torch.launch.train --arch falcon-mamba-7b`` (its
    smoke config, 2 MAMBA layers) trains on the CPU."""
    from repro_torch.launch import train as torch_train
    torch_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "2",
                      "--seq", "16", "--local-steps", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "step,a_i,loss,queue,seconds"
    losses = [float(r.split(",")[2]) for r in out[1:3]]
    assert all(np.isfinite(losses))
