"""The port's falcon-mamba-7b (smoke size) and its selective-scan kernel
against the JAX package, on the same parameters, tokens and inputs.

Kernel inputs and activations are numpy draws; parameters come from the
JAX package's ``init_params`` and reach the port through
``params_from_numpy``.  On the CPU the port's wrapper computes the plain
version of the kernel (`repro_torch.kernels.ref.selective_scan_ref`).

Tolerances:
  * the scan against the Pallas kernel (interpret mode) and the jnp
    oracle: tests/test_kernels.py's, atol 1e-5 (f32) or 5e-2 (bf16) with
    rtol 0.05, on y and h_last;
  * the Mamba layer, prefill and decode against the JAX package: max abs
    1e-4 (float32 on both sides, every state included; the two frameworks
    sum in other orders);
  * the port's own prefill + decode against its full-sequence forward:
    2e-2, the tolerance of tests/test_models.py's consistency tests.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import (launches, mamba_scan, ref,  # noqa: E402
                                 selective_scan)
from repro_torch.models import (LM, MAMBA, params_from_numpy,  # noqa: E402
                                unstack_layers)
from repro_torch.models.mamba import mamba_decode, mamba_forward  # noqa

try:            # the card's machine has no JAX: only the cuda test runs there
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.kernels import ref as jax_ref
    from repro.kernels.selective_scan import (
        selective_scan as jax_selective_scan)
    from repro.models import decode_step as jax_decode_step
    from repro.models import init_cache as jax_init_cache
    from repro.models import init_params as jax_init_params
    from repro.models import mamba as jax_mamba
    from repro.models import prefill as jax_prefill
except ImportError:
    jax = None

ARCH = "falcon-mamba-7b"
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TOL, SELF_TOL = 1e-4, 2e-2
S, GEN, BATCH = 40, 4, 2


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=atol, rtol=rtol)


def scan_inputs(B, S, Di, N, seed):
    """The draws of tests/test_kernels.py::test_selective_scan_sweep, from
    numpy: xc, dt = softplus(normal), Bc, Cc at scale 0.5, a random
    A = -exp(normal) (not the seeded init's log(n + 1) rows)."""
    g = np.random.default_rng(seed)
    xc = (g.standard_normal((B, S, Di)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(g.standard_normal((B, S, Di)))).astype(np.float32)
    Bc = (g.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cc = (g.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    A = -np.exp(g.standard_normal((Di, N))).astype(np.float32)
    return xc, dt, Bc, Cc, A


def _torch(arrays, dtype):
    """numpy -> torch; every input in ``dtype`` but A, which stays f32."""
    *acts, A = arrays
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in acts] + \
        [torch.from_numpy(A)]


def _jax(arrays, dtype):
    *acts, A = arrays
    return [jnp.asarray(a).astype(dtype) for a in acts] + [jnp.asarray(A)]


# the parametrisations of tests/test_kernels.py::test_selective_scan_sweep
SCAN_CASES = [
    (1, 32, 64, 8, 32, "float32"),
    (2, 64, 128, 16, 64, "float32"),
    (1, 48, 64, 8, 64, "bfloat16"),
]


@pytest.mark.parametrize("B,S,Di,N,bd,dtype", SCAN_CASES)
def test_selective_scan_matches_pallas(needs_jax, B, S, Di, N, bd, dtype):
    arrays = scan_inputs(B, S, Di, N, seed=S)
    jin = _jax(arrays, dtype)
    y, h = jax_selective_scan(*jin, bd=bd, interpret=True)
    yr, hr = jax_ref.selective_scan_ref(*jin)
    got_y, got_h = selective_scan(*_torch(arrays, dtype))
    assert got_y.dtype == getattr(torch, dtype)
    assert got_h.dtype == torch.float32 and got_h.shape == (B, Di, N)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for wy, wh in ((y, h), (yr, hr)):
        _close(got_y, wy, tol, 0.05)
        _close(got_h, wh, tol, 0.05)


@pytest.mark.parametrize("B,S,Di,N", [(3, 37, 100, 16), (1, 5, 3, 5)])
def test_selective_scan_ragged_matches_jax_ref(needs_jax, B, S, Di, N):
    """Any Di, S and N (the Pallas kernel needs Di % bd == 0)."""
    arrays = scan_inputs(B, S, Di, N, seed=Di)
    yr, hr = jax_ref.selective_scan_ref(*_jax(arrays, "float32"))
    y, h = mamba_scan(*_torch(arrays, "float32"))
    _close(y, yr, 1e-5, 0.05)
    _close(h, hr, 1e-5, 0.05)


LOG2E = np.float32(1.4426950408889634)


def _scan_exp2(xc, dt, Bc, Cc, A):
    """The CUDA kernel's numerics, emulated: dA = exp2(dt (A log2 e)) with
    A log2 e rounded to f32, the update h = fma(dA, h, (dt x) B) rounded
    once (taken in f64, rounded to f32), dt x in the input type, and
    y = sum_n h C in f32."""
    B, S, Di = xc.shape
    a2 = A.float() * float(LOG2E)
    h = torch.zeros((B, Di, A.shape[1]), dtype=torch.float32)
    y = torch.empty_like(xc)
    for t in range(S):
        dA = torch.exp2(dt[:, t, :, None].float() * a2)
        dbx = (dt[:, t] * xc[:, t]).float()[..., None] * \
            Bc[:, t, None, :].float()
        h = (dA.double() * h.double() + dbx.double()).float()
        y[:, t] = torch.einsum("bdn,bn->bd", h,
                               Cc[:, t].float()).to(xc.dtype)
    return y, h


@pytest.mark.parametrize(
    "B,S,Di,N,dtype", [c[:4] + c[5:] for c in SCAN_CASES] +
    [(3, 37, 100, 16, "float32"), (1, 5, 3, 5, "float32")])
def test_exp2_scan_numerics_meet_the_tolerance(B, S, Di, N, dtype):
    """exp2 on a pre-scaled A and the fused update stay within atol 1e-5
    (5e-2 in bf16) and rtol 0.05 of the plain version: the JAX sweep's
    shapes and ragged ones."""
    args = _torch(scan_inputs(B, S, Di, N, seed=Di + N), dtype)
    y, h = _scan_exp2(*args)
    yr, hr = ref.selective_scan_ref(*args)
    tol = 1e-5 if dtype == "float32" else 5e-2
    _close(y, yr, tol, 0.05)
    _close(h, hr, tol, 0.05)


def test_cpu_tensors_take_the_plain_version_without_launching():
    xc, dt, Bc, Cc, A = _torch(scan_inputs(2, 9, 12, 16, seed=0), "float32")
    before = dict(launches)
    for got, want in zip(selective_scan(xc, dt, Bc, Cc, A),
                         ref.selective_scan_ref(xc, dt, Bc, Cc, A)):
        assert torch.equal(got, want)
    # strided inputs (the model's views of x_proj's output) too
    dbc = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 9, 32)).astype(np.float32))
    mamba_scan(xc, dt, dbc[..., :16], dbc[..., 16:], A)
    assert launches == before and launches["selective_scan"] == 0


class Pair:
    """falcon-mamba-7b smoke on both sides: JAX parameters and the port's
    LM holding the same numbers."""

    def __init__(self):
        self.cfg = get_smoke_config(ARCH)
        self.jcfg = jax_smoke_config(ARCH)
        self.jparams = jax_init_params(jax.random.PRNGKey(0), self.jcfg)
        self.model = params_from_numpy(jax.tree.map(np.asarray, self.jparams),
                                       self.cfg, device="cpu")
        self.jlayers = unstack_layers(self.jparams, self.cfg)


@pytest.fixture(scope="module")
def pair():
    if jax is None:
        pytest.skip("the JAX package is not installed")
    return Pair()


def test_configs_match_the_jax_package(needs_jax):
    for arch in (ARCH, "falcon_mamba_7b"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke_config(arch))
    full = get_config(ARCH)
    assert full.param_count() == 7_005_540_352
    assert full.layer_kinds() == (MAMBA,) * 64
    assert (full.d_inner, full.ssm_state, full.dt_rank, full.padded_vocab) \
        == (8192, 16, 256, 65024)


def test_mamba_layer_forward_and_decode_match_jax(pair):
    """The first layer's Mamba block with its state (y, h, conv tail),
    then one decode step from the JAX package's state."""
    cfg = pair.cfg
    g = np.random.default_rng(3)
    x = g.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32)
    x1 = g.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
    jp = pair.jlayers[0]["mamba"]
    jy, jst = jax_mamba.mamba_forward(jp, pair.jcfg, jnp.asarray(x),
                                      return_state=True)
    p = pair.model.layers[0].mamba
    with torch.inference_mode():
        y, st = mamba_forward(p, cfg, torch.from_numpy(x), return_state=True)
    _close(y, jy, TOL)
    assert st["h"].shape == (BATCH, cfg.d_inner, cfg.ssm_state)
    assert st["conv"].shape == (BATCH, cfg.ssm_conv - 1, cfg.d_inner)
    _close(st["h"], jst["h"], TOL)
    _close(st["conv"], jst["conv"], TOL)
    jy1, jst1 = jax_mamba.mamba_decode(jp, pair.jcfg, jnp.asarray(x1), jst,
                                       jnp.int32(S))
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    with torch.inference_mode():
        y1, st1 = mamba_decode(p, cfg, torch.from_numpy(x1), cache, S)
    _close(y1, jy1, TOL)
    _close(st1["h"], jst1["h"], TOL)
    _close(st1["conv"], jst1["conv"], TOL)


def test_short_prompt_pads_the_conv_tail(pair):
    """S < K - 1: the conv tail is left-padded with zeros, as in JAX."""
    cfg = pair.cfg
    x = np.random.default_rng(4).standard_normal(
        (BATCH, 2, cfg.d_model)).astype(np.float32)
    _, jst = jax_mamba.mamba_forward(pair.jlayers[1]["mamba"], pair.jcfg,
                                     jnp.asarray(x), return_state=True)
    with torch.inference_mode():
        _, st = mamba_forward(pair.model.layers[1].mamba, cfg,
                              torch.from_numpy(x), return_state=True)
    assert st["conv"].shape == (BATCH, cfg.ssm_conv - 1, cfg.d_inner)
    assert not st["conv"][:, 0].any()
    _close(st["conv"], jst["conv"], TOL)
    _close(st["h"], jst["h"], TOL)


@pytest.fixture(scope="module")
def served(pair):
    """JAX prefill of S tokens then GEN greedy decode steps, and the port's
    on the same tokens (the JAX package's greedy picks feed both)."""
    cfg, jcfg = pair.cfg, pair.jcfg
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, t: jax_prefill(
        p, jcfg, t, cache_len=S + GEN))(pair.jparams, jnp.asarray(toks))
    jstep = jax.jit(lambda p, c, t, s: jax_decode_step(p, c, jcfg, t, s))
    with torch.inference_mode():
        log, cache = pair.model.prefill(torch.from_numpy(toks).long(),
                                        cache_len=S + GEN)
    out = {"prefill": (log, jlog),
           "cache": ([{k: v.clone() for k, v in c.items()} for c in cache],
                     unstack_layers(jax.tree.map(np.asarray, jcache), cfg)),
           "steps": []}
    tok = jnp.argmax(jlog, axis=-1)
    for i in range(GEN):
        jlog, jcache = jstep(pair.jparams, jcache, tok, jnp.int32(S + i))
        with torch.inference_mode():
            log, cache = pair.model.decode_step(
                cache, torch.from_numpy(np.array(tok)).long(), S + i)
        out["steps"].append((log.clone(), jlog))
        tok = jnp.argmax(jlog, axis=-1)
    return out


def test_prefill_logits_and_state_match_jax(served, pair):
    log, jlog = served["prefill"]
    assert log.shape == (BATCH, pair.cfg.vocab_size)
    _close(log, jlog, TOL)
    got, want = served["cache"]
    assert len(got) == len(want) == pair.cfg.num_layers
    for c, jc in zip(got, want):
        assert set(c) == set(jc) == {"h", "conv"}
        for key in jc:
            assert c[key].dtype == torch.float32
            _close(c[key], jc[key], TOL)


@pytest.mark.parametrize("i", range(GEN))
def test_greedy_decode_steps_match_jax(served, i):
    log, jlog = served["steps"][i]
    _close(log, jlog, TOL)


def test_init_cache_matches_jax_layout(needs_jax):
    """The empty cache: f32 state and f32 conv history in every layer, as
    the JAX package's init_cache gives MAMBA layers (no dtype passed)."""
    cfg = get_smoke_config(ARCH)
    want = unstack_layers(jax.tree.map(np.asarray, jax_init_cache(
        jax_smoke_config(ARCH), BATCH, S + GEN)), cfg)
    got = LM(cfg, device="cpu", seed=None).init_cache(BATCH, S + GEN)
    for c, jc in zip(got, want):
        assert set(c) == set(jc)
        for key in jc:
            assert tuple(c[key].shape) == jc[key].shape
            assert str(c[key].dtype).split(".")[1] == str(jc[key].dtype)
            assert not c[key].any()


def test_prefill_then_decode_matches_full_forward():
    """The port alone: prefill of S tokens then decode of tokens S and
    S + 1, against the full-sequence forward's logits."""
    cfg = get_smoke_config(ARCH)
    model = LM(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (BATCH, S + 2))).long()
    with torch.inference_mode():
        full = model(toks)
        log, cache = model.prefill(toks[:, :S], cache_len=S + 8)
        s0, cache = model.decode_step(cache, toks[:, S], S)
        s1, _ = model.decode_step(cache, toks[:, S + 1], S + 1)
    assert not any(hasattr(layer, "ln2") or hasattr(layer, "mlp")
                   for layer in model.layers)
    for got, want in ((log, full[:, S - 1]), (s0, full[:, S]),
                      (s1, full[:, S + 1])):
        assert float((got - want).abs().max()) < SELF_TOL


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", ARCH, "--prompt-len", "24", "--gen", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill,4x24,")
    assert lines[1].startswith("decode,8_tokens,")
    assert lines[2].startswith("sample_ids:")


@pytest.mark.cuda
def test_cuda_selective_scan_matches_plain_version():
    """The CUDA kernel against its plain version on the card: the JAX
    tests' parametrisations, ragged Di (not a multiple of 64 or of 16
    bytes), S (1, not a multiple of the 32-step chunk) and N (1, 5, 8,
    16, 17, 64), bf16, and a wide channel count at N = 16; each launch
    counted, and non-contiguous inputs refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    dev = torch.device("cuda")
    cases = [(B, S_, Di, N, dt) for B, S_, Di, N, _, dt in SCAN_CASES]
    cases += [(3, 37, 100, 16, "float32"), (1, 5, 3, 5, "float32"),
              (2, 70, 100, 16, "bfloat16"), (1, 300, 8192, 16, "float32"),
              (2, 33, 130, 64, "float32"), (1, 1, 64, 16, "float32"),
              (2, 45, 130, 1, "float32"), (1, 33, 96, 17, "float32"),
              (1, 65, 64, 64, "bfloat16"), (1, 50, 128, 17, "bfloat16"),
              (2, 31, 72, 8, "float32")]
    before = launches["selective_scan"]
    for i, (B, S_, Di, N, dtype) in enumerate(cases):
        xc, dt, Bc, Cc, A = (t.to(dev) for t in _torch(
            scan_inputs(B, S_, Di, N, seed=i), dtype))
        y, h = selective_scan(xc, dt, Bc, Cc, A)
        yr, hr = ref.selective_scan_ref(xc, dt, Bc, Cc, A)
        tol = 1e-5 if dtype == "float32" else 5e-2
        torch.testing.assert_close(y.float(), yr.float(), atol=tol,
                                   rtol=0.05)
        torch.testing.assert_close(h, hr, atol=tol, rtol=0.05)
    torch.cuda.synchronize()
    assert launches["selective_scan"] - before == len(cases)
    with pytest.raises(ValueError, match="contiguous"):
        selective_scan(xc.transpose(1, 2).contiguous().transpose(1, 2), dt,
                       Bc, Cc, A)
