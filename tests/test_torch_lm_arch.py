"""The port's serving of five more architectures against the JAX package
at smoke size: gemma-7b and granite-3-8b (configs only: MHA with GeGLU,
GQA with SiLU), qwen1.5-32b (qkv bias), chameleon-34b (qk-norm) and
musicgen-large (four audio codebooks).  The MoE architectures are in
tests/test_torch_lm_moe.py, which imports this file's harness.

Parameters come from the JAX package's ``init_params`` and reach the port
through ``params_from_numpy``; prompts are numpy draws, and the JAX
package's greedy picks feed both sides' decode steps.  Each
architecture's JAX reference (a jitted prefill and two decode steps) runs
once, in a module fixture.  On the CPU the port's attention reaches the
kernel's plain version.

Tolerances (max abs), those of tests/test_torch_lm.py: prefill logits
1e-4 (float32 on both sides, sums in other orders); decode logits 2e-3
(both sides keep K/V in bfloat16 and take the softmax weights to bfloat16
before the product with V); bfloat16 cache entries 1e-2 absolute and
relative, positions exactly; the port's own prefill and decode against
its full-sequence forward 2e-2 (tests/test_models.py's consistency
bound).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import (LM, params_from_numpy,  # noqa: E402
                                params_to_numpy, unstack_layers)
from repro_torch.models import attention as tattn  # noqa: E402

try:            # the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import attention as jattn
    from repro.models import decode_step as jax_decode_step
    from repro.models import init_cache as jax_init_cache
    from repro.models import init_params as jax_init_params
    from repro.models import prefill as jax_prefill
except ImportError:
    jax = None

PREFILL_TOL, DECODE_TOL, BF16_TOL, SELF_TOL = 1e-4, 2e-3, 1e-2, 2e-2
S, STEPS, BATCH = 40, 2, 2
ARCHS = ["gemma-7b", "granite-3-8b", "qwen1.5-32b", "chameleon-34b",
         "musicgen-large"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, tol, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=rtol)


def prompts(cfg, n, seed):
    """(B, n) token ids, or (B, K, n) for K codebooks."""
    shape = (BATCH, n) if cfg.num_codebooks == 1 else \
        (BATCH, cfg.num_codebooks, n)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def compare_cache(got, want):
    """One layer's cache: positions exactly, bfloat16 entries at 1e-2."""
    assert set(got) == set(want)
    for key in want:
        if key == "pos":
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        else:
            assert got[key].dtype == torch.bfloat16
            close(got[key], want[key], BF16_TOL, BF16_TOL)


class Served:
    """One architecture on both sides, from the JAX package's parameters:
    a prefill of S tokens, then ``STEPS`` greedy decode steps (the JAX
    package's picks feed both) for each decode variant, a config with
    fields replaced (MLA's naive decode) or the config itself."""

    def __init__(self, arch, seed, variants=(("decode", {}),)):
        self.cfg = get_smoke_config(arch)
        self.jcfg = jax_smoke_config(arch)
        self.jparams = jax_init_params(jax.random.PRNGKey(0), self.jcfg)
        self.tree = jax.tree.map(np.asarray, self.jparams)
        self.model = params_from_numpy(self.tree, self.cfg, device="cpu")
        self.toks = prompts(self.cfg, S, seed)
        cache_len = S + STEPS
        jlog, jcache = jax.jit(lambda p, t: jax_prefill(
            p, self.jcfg, t, cache_len=cache_len))(self.jparams,
                                                   jnp.asarray(self.toks))
        with torch.inference_mode():
            log, cache = self.model.prefill(
                torch.from_numpy(self.toks).long(), cache_len=cache_len)
        self.prefill = (log, jlog)
        self.cache = ([{k: v.clone() for k, v in c.items()} for c in cache],
                      unstack_layers(jax.tree.map(np.asarray, jcache),
                                     self.cfg))
        self.steps = {}
        for name, fields in variants:
            jc = dataclasses.replace(self.jcfg, **fields)
            model = (params_from_numpy(self.tree, dataclasses.replace(
                self.cfg, **fields), device="cpu") if fields else self.model)
            jstep = jax.jit(lambda p, c, t, s, jc=jc: jax_decode_step(
                p, c, jc, t, s))
            tc = [{k: v.clone() for k, v in c.items()} for c in cache]
            jcc, jl, out = jcache, jlog, []
            for i in range(STEPS):
                tok = jnp.argmax(jl, axis=-1)
                jl, jcc = jstep(self.jparams, jcc, tok, jnp.int32(S + i))
                with torch.inference_mode():
                    lg, tc = model.decode_step(
                        tc, torch.from_numpy(np.array(tok)).long(), S + i)
                out.append((lg.clone(), jl))
            self.steps[name] = out
        self.final_cache = (tc, unstack_layers(jax.tree.map(np.asarray, jcc),
                                               self.cfg))


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    if jax is None:
        pytest.skip("the JAX package is not installed")
    return Served(request.param, seed=ARCHS.index(request.param))


@pytest.mark.parametrize("arch", ARCHS + ["qwen1_5_32b", "musicgen_large"])
def test_configs_match_the_jax_package(arch):
    if jax is None:
        pytest.skip("the JAX package is not installed")
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))


def test_prefill_logits_and_cache_match_jax(served):
    log, jlog = served.prefill
    K = served.cfg.num_codebooks
    assert tuple(log.shape) == ((BATCH, served.cfg.vocab_size) if K == 1
                                else (BATCH, K, served.cfg.vocab_size))
    close(log, jlog, PREFILL_TOL)
    got, want = served.cache
    assert len(got) == len(want) == served.cfg.num_layers
    for c, jc in zip(got, want):
        compare_cache(c, jc)


@pytest.mark.parametrize("i", range(STEPS))
def test_greedy_decode_steps_match_jax(served, i):
    log, jlog = served.steps["decode"][i]
    assert log.shape == jlog.shape
    close(log, jlog, DECODE_TOL)
    if i == STEPS - 1:
        for c, jc in zip(*served.final_cache):
            compare_cache(c, jc)


def test_params_round_trip_exactly(served):
    back = params_to_numpy(served.model)
    jax.tree.map(np.testing.assert_array_equal, back, served.tree)
    assert jax.tree.structure(back) == jax.tree.structure(served.tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_full_forward(arch):
    """The port alone: prefill of S tokens then decode of token S, against
    the full-sequence forward's logits at S - 1 and S."""
    cfg = get_smoke_config(arch)
    model = LM(cfg, device="cpu", seed=0)
    toks = torch.from_numpy(prompts(cfg, S + 1, seed=5)).long()
    with torch.inference_mode():
        full = model(toks)
        log, cache = model.prefill(toks[..., :S], cache_len=S + 8)
        step, _ = model.decode_step(cache, toks[..., S], S)
    assert float((log - full[..., S - 1, :]).abs().max()) < SELF_TOL
    assert float((step - full[..., S, :]).abs().max()) < SELF_TOL


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "chameleon-34b"])
def test_biased_and_normed_attention_matches_jax(arch):
    """The attention layer alone with non-zero biases and qk-norm weights
    (the init's are zeros and ones): forward with its cache, then one
    decode step against the JAX package's cache."""
    if jax is None:
        pytest.skip("the JAX package is not installed")
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    g = np.random.default_rng(7)
    jp = {k: np.array(v) for k, v in
          jattn.init_attn(jax.random.PRNGKey(3), jcfg).items()}
    moved = [k for k in ("bq", "bk", "bv", "qnorm", "knorm") if k in jp]
    assert len(moved) in (2, 3)
    for k in moved:
        jp[k] = jp[k] + (g.standard_normal(jp[k].shape) * 0.5).astype(
            np.float32)
    p = {k: torch.from_numpy(v) for k, v in jp.items()}
    x = g.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32)
    x1 = g.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
    jy, jc = jax.jit(lambda p_, x_: jattn.attn_forward(
        p_, jcfg, x_, "attn", return_cache=True, cache_len=S + 1))(
            jp, jnp.asarray(x))
    with torch.inference_mode():
        y, c = tattn.attn_forward(p, cfg, torch.from_numpy(x), "attn",
                                  return_cache=True, cache_len=S + 1)
    close(y, jy, PREFILL_TOL)
    compare_cache(c, jc)
    jy1, _ = jax.jit(lambda p_, x_, c_: jattn.attn_decode(
        p_, jcfg, x_, c_, jnp.int32(S), "attn"))(jp, jnp.asarray(x1), jc)
    with torch.inference_mode():
        y1, _ = tattn.attn_decode(p, cfg, torch.from_numpy(x1), c, S, "attn")
    close(y1, jy1, DECODE_TOL)


@pytest.mark.parametrize("arch", ["musicgen-large", "deepseek-v2-236b"])
def test_init_cache_matches_jax_layout(arch):
    """The empty cache has the JAX package's shapes, dtypes and positions
    layer by layer (MLA: the latent and the shared roped key)."""
    if jax is None:
        pytest.skip("the JAX package is not installed")
    cfg = get_smoke_config(arch)
    want = unstack_layers(jax.tree.map(np.asarray, jax_init_cache(
        jax_smoke_config(arch), BATCH, S)), cfg)
    got = LM(cfg, device="cpu", seed=None).init_cache(BATCH, S)
    for c, jc in zip(got, want):
        assert set(c) == set(jc)
        for key in jc:
            assert tuple(c[key].shape) == jc[key].shape
            assert str(c[key].dtype).split(".")[1] == str(jc[key].dtype)
            np.testing.assert_array_equal(_np(c[key]), jc[key].astype(
                np.float32))


def test_audio_generate_samples_every_codebook():
    """musicgen's prompts are (B, K, S) and its tokens (B, K, gen); greedy
    tokens are each codebook's argmax."""
    cfg = get_smoke_config("musicgen-large")
    r = generate(cfg, batch=2, prompt_len=12, gen=3, temperature=0,
                 device="cpu")
    K = cfg.num_codebooks
    assert r.prompts.shape == (2, K, 12) and r.tokens.shape == (2, K, 3)
    assert r.prefill_logits.shape == (2, K, cfg.vocab_size)
    assert torch.equal(r.tokens[..., 0], r.prefill_logits.argmax(-1))
    for step, logits in enumerate(r.decode_logits, start=1):
        assert torch.equal(r.tokens[..., step], logits.argmax(-1))
    sampled = generate(cfg, batch=2, prompt_len=12, gen=3, temperature=1.0,
                       device="cpu")
    assert sampled.tokens.shape == (2, K, 3)
    assert int(sampled.tokens.max()) < cfg.vocab_size
