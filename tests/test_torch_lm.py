"""The port's language models (recurrentgemma-2b and gemma-2b, smoke size)
against the JAX package's on the same parameters and tokens.

Parameters come from the JAX package's ``init_params`` and reach the port
through ``params_from_numpy``; tokens and activations are numpy draws.  On
the CPU the port's layers reach the plain versions of its kernels.

Tolerances (max abs):
  * prefill and full-sequence outputs: 1e-4 (float32 on both sides; the
    two frameworks sum in other orders);
  * decode outputs: 2e-3.  Both sides store K/V in bfloat16 and take the
    decode softmax weights to bfloat16 before the product with V, so one
    rounding that lands on the other side of a bfloat16 step moves the
    result by up to ~1e-3;
  * bfloat16 cache entries: 1e-2 absolute and relative (one bfloat16 step
    is 2^-8 relative); cache positions and float32 states exactly / 1e-4;
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
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.models import (LM, LOCAL, RGLRU,  # noqa: E402
                                lm_loss, params_from_numpy, unstack_layers)
from repro_torch.models.attention import attn_decode, attn_forward  # noqa
from repro_torch.models.rglru import rglru_decode, rglru_forward  # noqa

try:
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import decode_step as jax_decode_step
    from repro.models import init_params as jax_init_params
    from repro.models import prefill as jax_prefill
    from repro.models import attention as jax_attention
    from repro.models import rglru as jax_rglru
except ImportError:
    jax = None

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
PREFILL_TOL, DECODE_TOL, BF16_TOL, SELF_TOL = 1e-4, 2e-3, 1e-2, 2e-2
S, GEN, BATCH = 96, 4, 2          # S > the smoke window (64): the ring wraps


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=rtol)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, n)).astype(np.int32)


def _torch_cache(layer_cache):
    """A JAX layer cache -> tensors of the same dtypes (bfloat16 through
    float32, which holds it exactly)."""
    out = {}
    for k, v in layer_cache.items():
        dtype = getattr(torch, str(v.dtype))
        host = np.array(v, np.float32 if v.dtype == jnp.bfloat16 else None)
        out[k] = torch.from_numpy(host).to(dtype)
    return out


def _compare_cache(got, want):
    for key in want:
        if key == "pos":
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(
                want[key]))
        elif got[key].dtype == torch.bfloat16:
            _close(got[key], want[key], BF16_TOL, BF16_TOL)
        else:
            _close(got[key], want[key], PREFILL_TOL)


class Pair:
    """One architecture on both sides: JAX parameters and the port's LM."""

    def __init__(self, arch):
        self.cfg = get_smoke_config(arch)
        self.jcfg = jax_smoke_config(arch)
        self.jparams = jax_init_params(jax.random.PRNGKey(0), self.jcfg)
        tree = jax.tree.map(np.asarray, self.jparams)
        self.model = params_from_numpy(tree, self.cfg, device="cpu")
        self.jlayers = unstack_layers(self.jparams, self.cfg)


@pytest.fixture(scope="module")
def rgemma():
    if jax is None:
        pytest.skip("the JAX package is not installed")
    return Pair("recurrentgemma-2b")


@pytest.fixture(scope="module")
def served(rgemma):
    """JAX prefill of S tokens then GEN greedy decode steps, and the port's
    on the same tokens (the JAX package's greedy picks feed both)."""
    return _serve_both(rgemma, seed=1)


def _serve_both(pair, seed):
    cfg, jcfg = pair.cfg, pair.jcfg
    toks = _tokens(cfg, S, seed)
    jpre = jax.jit(lambda p, t: jax_prefill(p, jcfg, t, cache_len=S + GEN,
                                            q_chunk=1024))
    jstep = jax.jit(lambda p, c, t, s: jax_decode_step(p, c, jcfg, t, s))
    jlog, jcache = jpre(pair.jparams, jnp.asarray(toks))
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


def test_configs_match_the_jax_package(needs_jax):
    from repro.configs import get_config as jax_config
    for arch in ("recurrentgemma-2b", "gemma-2b", "recurrentgemma_2b"):
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke_config(arch))
    full = get_config("recurrentgemma-2b")
    kinds = full.layer_kinds()
    assert (full.num_layers, kinds.count(LOCAL), kinds.count(RGLRU)) == \
        (26, 8, 18)


@pytest.mark.parametrize("arch", ["gpt-2", "gemma_3b", "paper-cifar"])
def test_unknown_architectures_raise_key_error(arch):
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config(arch)
    with pytest.raises(KeyError, match="unknown architecture"):
        get_smoke_config(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_architecture_back_propagates(arch):
    """Every architecture trains (the MoE, MLA and audio models too): the
    loss of a smoke model under the per-layer checkpoint is finite and
    gives every parameter a finite, nonzero gradient."""
    cfg = get_smoke_config(arch)
    model = LM(cfg, seed=0, trainable=True)
    g = torch.Generator().manual_seed(1)
    books = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    toks = torch.randint(0, cfg.vocab_size, (2,) + books + (17,),
                         generator=g)
    loss = lm_loss(model, {"tokens": toks[..., :-1],
                           "labels": toks[..., 1:]}, remat=True)
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


def test_attn_forward_and_decode_match_jax(rgemma):
    """The first LOCAL layer (2) on its own, with its ring-buffer cache,
    then one decode step against that cache."""
    cfg = rgemma.cfg
    g = np.random.default_rng(2)
    x = g.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32)
    x1 = g.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
    jp = rgemma.jlayers[2]["attn"]
    jy, jc = jax_attention.attn_forward(jp, rgemma.jcfg, jnp.asarray(x),
                                        LOCAL, return_cache=True,
                                        cache_len=S + GEN)
    p = rgemma.model.layers[2].attn
    with torch.inference_mode():
        y, c = attn_forward(p, cfg, torch.from_numpy(x), LOCAL,
                            return_cache=True, cache_len=S + GEN)
    _close(y, jy, PREFILL_TOL)
    assert c["k"].shape == (BATCH, cfg.window, 1, cfg.head_dim)
    _compare_cache(c, jc)
    jy1, jc1 = jax_attention.attn_decode(jp, rgemma.jcfg, jnp.asarray(x1),
                                         jc, jnp.int32(S), LOCAL)
    with torch.inference_mode():
        y1, c1 = attn_decode(p, cfg, torch.from_numpy(x1),
                             _torch_cache(jc), S, LOCAL)
    _close(y1, jy1, DECODE_TOL)
    _compare_cache(c1, jc1)


def test_rglru_forward_and_decode_match_jax(rgemma):
    """The first RG-LRU layer (0) with its state, then one decode step."""
    cfg = rgemma.cfg
    g = np.random.default_rng(3)
    x = g.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32)
    x1 = g.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
    jp = rgemma.jlayers[0]["rglru"]
    jy, jst = jax_rglru.rglru_forward(jp, rgemma.jcfg, jnp.asarray(x),
                                      return_state=True)
    p = rgemma.model.layers[0].rglru
    with torch.inference_mode():
        y, st = rglru_forward(p, cfg, torch.from_numpy(x), return_state=True)
    _close(y, jy, PREFILL_TOL)
    _close(st["h"], jst["h"], PREFILL_TOL)
    _close(st["conv"], jst["conv"], PREFILL_TOL)
    jy1, jst1 = jax_rglru.rglru_decode(jp, rgemma.jcfg, jnp.asarray(x1),
                                       jst, jnp.int32(S))
    with torch.inference_mode():
        y1, st1 = rglru_decode(p, cfg, torch.from_numpy(x1),
                               _torch_cache(jst), S)
    _close(y1, jy1, PREFILL_TOL)
    _close(st1["h"], jst1["h"], PREFILL_TOL)
    _close(st1["conv"], jst1["conv"], PREFILL_TOL)


def test_prefill_logits_and_cache_match_jax(served, rgemma):
    log, jlog = served["prefill"]
    assert log.shape == (BATCH, rgemma.cfg.vocab_size)
    _close(log, jlog, PREFILL_TOL)
    got, want = served["cache"]
    assert len(got) == len(want) == rgemma.cfg.num_layers
    for i, (c, jc) in enumerate(zip(got, want)):
        assert set(c) == set(jc), i
        _compare_cache(c, jc)


@pytest.mark.parametrize("i", range(GEN))
def test_greedy_decode_steps_match_jax(served, i):
    log, jlog = served["steps"][i]
    _close(log, jlog, DECODE_TOL)


def test_gemma_2b_prefill_and_decode_match_jax(needs_jax):
    """Global attention only: the kernel with window 0, a cache of the
    whole length."""
    out = _serve_both(Pair("gemma-2b"), seed=4)
    _close(*out["prefill"], PREFILL_TOL)
    for c, jc in zip(*out["cache"]):
        _compare_cache(c, jc)
    for log, jlog in out["steps"]:
        _close(log, jlog, DECODE_TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "gemma-2b"])
def test_prefill_then_decode_matches_full_forward(arch):
    """The port alone: prefill of S tokens then decode of token S, against
    the full-sequence forward's logits at S - 1 and S."""
    cfg = get_smoke_config(arch)
    model = LM(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(_tokens(cfg, S + 1, seed=5)).long()
    with torch.inference_mode():
        full = model(toks)
        log, cache = model.prefill(toks[:, :S], cache_len=S + 8)
        step, _ = model.decode_step(cache, toks[:, S], S)
    assert float((log - full[:, S - 1]).abs().max()) < SELF_TOL
    assert float((step - full[:, S]).abs().max()) < SELF_TOL


def test_generate_greedy_is_deterministic():
    cfg = get_smoke_config("recurrentgemma-2b")
    a, b = (generate(cfg, batch=2, prompt_len=70, gen=3, temperature=0,
                     device="cpu") for _ in range(2))
    assert a.tokens.shape == (2, 3) and len(a.decode_logits) == 2
    assert torch.equal(a.prompts, b.prompts) and torch.equal(a.tokens,
                                                             b.tokens)
    assert torch.equal(a.tokens[:, 0], a.prefill_logits.argmax(-1))
    for step, logits in enumerate(a.decode_logits, start=1):
        assert torch.equal(a.tokens[:, step], logits.argmax(-1))


def test_init_cache_matches_jax_layout(needs_jax):
    """The empty cache has the JAX package's shapes, dtypes and positions
    layer by layer (ring buffers of the window for LOCAL layers)."""
    from repro.models import init_cache as jax_init_cache
    cfg = get_smoke_config("recurrentgemma-2b")
    want = unstack_layers(jax.tree.map(np.asarray, jax_init_cache(
        jax_smoke_config("recurrentgemma-2b"), BATCH, S + GEN)), cfg)
    got = LM(cfg, device="cpu", seed=None).init_cache(BATCH, S + GEN)
    for c, jc in zip(got, want):
        assert set(c) == set(jc)
        for key in jc:
            assert tuple(c[key].shape) == jc[key].shape
            assert str(c[key].dtype).split(".")[1] == str(jc[key].dtype)
            np.testing.assert_array_equal(_np(c[key]), jc[key].astype(
                np.float32))


def test_token_stream_is_zipf():
    from repro_torch.data import token_stream
    toks = token_stream(torch.Generator().manual_seed(0), 20000, 1000)
    counts = torch.bincount(toks, minlength=1000)
    assert toks.dtype == torch.int64 and int(toks.max()) < 1000
    assert counts[:10].sum() > 20 * counts[500:510].sum()   # head-heavy


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "recurrentgemma-2b", "--prompt-len", "40", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill,4x40,")
    assert lines[1].startswith("decode,12_tokens,")
    assert lines[2].startswith("sample_ids:")
