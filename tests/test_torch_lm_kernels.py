"""The port's flash-attention and RG-LRU scan kernels against the JAX
package's Pallas kernels (run with interpret=True) and its jnp oracles
(`repro.kernels.ref`), on the same numpy inputs.

On the CPU the port's wrappers compute their plain versions
(`repro_torch.kernels.ref`); the `cuda`-marked test holds the CUDA kernels
against those plain versions on the card.  Tolerances are
`tests/test_kernels.py`'s: attention 2e-5 (f32) and 3e-2 (bf16), absolute
and relative; the scan 1e-5 (f32) and 5e-2 (bf16) absolute with 5e-2
relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (the thread budget under xdist)

from repro_torch.kernels import (flash_attention, launches,  # noqa: E402
                                 reset_launches, rglru_scan)
from repro_torch.kernels import ref  # noqa: E402

try:            # the card's machine has no JAX: only the cuda test runs there
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    from repro.kernels.flash_attention import (
        flash_attention as jax_flash_attention)
    from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
except ImportError:
    jax = None


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("the JAX package is not installed")


def _attn_inputs(B, S, H, d, seed, Kv=None):
    g = np.random.default_rng(seed)
    Kv = H if Kv is None else Kv
    q = (g.standard_normal((B, S, H, d)) * 0.3).astype(np.float32)
    k = (g.standard_normal((B, S, Kv, d)) * 0.3).astype(np.float32)
    v = g.standard_normal((B, S, Kv, d)).astype(np.float32)
    return q, k, v


def _scan_inputs(B, S, W, seed):
    g = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-g.standard_normal((B, S, W))))).astype(
        np.float32)
    bx = (g.standard_normal((B, S, W)) * 0.3).astype(np.float32)
    return a, bx


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(x.float() if hasattr(x, "float") else x, np.float32)


# the parametrisations of tests/test_kernels.py::test_flash_attention_sweep
ATTN_CASES = [
    (1, 256, 2, 64, 0, 0.0, "float32"),
    (2, 512, 4, 64, 0, 0.0, "float32"),
    (1, 512, 2, 128, 128, 0.0, "float32"),      # sliding window
    (1, 256, 2, 64, 0, 30.0, "float32"),        # softcap
    (1, 256, 2, 64, 0, 0.0, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,d,window,softcap,dtype", ATTN_CASES)
def test_flash_attention_matches_pallas(needs_jax, B, S, H, d, window,
                                        softcap, dtype):
    q, k, v = _attn_inputs(B, S, H, d, seed=S + H + window)
    want = jax_flash_attention(
        _to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype), bq=128,
        bk=128, window=window, softcap=softcap, interpret=True)
    want_ref = jax_ref.flash_attention_ref(
        _to_jax(q, dtype), _to_jax(k, dtype), _to_jax(v, dtype),
        window=window, softcap=softcap)
    got = flash_attention(_to_torch(q, dtype), _to_torch(k, dtype),
                          _to_torch(v, dtype), window=window,
                          softcap=softcap)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, d)
    tol = 2e-5 if dtype == "float32" else 3e-2
    for w in (want, want_ref):
        np.testing.assert_allclose(_f32(got), _f32(w), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,window", [(100, 0), (100, 16), (77, 200)])
def test_flash_attention_ragged_grouped_matches_jax_ref(needs_jax, S,
                                                        window):
    """Any S (the Pallas kernel needs S % bq == 0), and grouped K/V heads
    read in place: query head h against K/V head h // (H / Kv), held
    against the JAX oracle on heads repeated by hand."""
    H, Kv, d = 6, 2, 32
    q, k, v = _attn_inputs(2, S, H, d, seed=S, Kv=Kv)
    rep = lambda x: np.repeat(x, H // Kv, axis=2)
    want = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(rep(k)),
                                       jnp.asarray(rep(v)), window=window)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


# the parametrisations of tests/test_kernels.py::test_rglru_scan_sweep
SCAN_CASES = [
    (1, 32, 64, 64, "float32"),
    (2, 64, 256, 128, "float32"),
    (1, 64, 128, 128, "bfloat16"),
]


@pytest.mark.parametrize("B,S,W,bw,dtype", SCAN_CASES)
def test_rglru_scan_matches_pallas(needs_jax, B, S, W, bw, dtype):
    a, bx = _scan_inputs(B, S, W, seed=W)
    ja, jbx = _to_jax(a, dtype), _to_jax(bx, dtype)
    y, h = jax_rglru_scan(ja, jbx, bw=bw, interpret=True)
    yr, hr = jax_ref.rglru_scan_ref(ja, jbx)
    got_y, got_h = rglru_scan(_to_torch(a, dtype), _to_torch(bx, dtype))
    assert got_y.dtype == getattr(torch, dtype) and got_h.dtype == \
        torch.float32 and got_h.shape == (B, W)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for wy, wh in ((y, h), (yr, hr)):
        np.testing.assert_allclose(_f32(got_y), _f32(wy), atol=tol,
                                   rtol=0.05)
        np.testing.assert_allclose(_f32(got_h), _f32(wh), atol=tol,
                                   rtol=0.05)


def test_rglru_scan_ragged_width_matches_jax_ref(needs_jax):
    """Any W (the Pallas kernel needs W % bw == 0) and S."""
    a, bx = _scan_inputs(3, 37, 100, seed=3)
    yr, hr = jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bx))
    y, h = rglru_scan(torch.from_numpy(a), torch.from_numpy(bx))
    np.testing.assert_allclose(_f32(y), _f32(yr), atol=1e-5, rtol=0.05)
    np.testing.assert_allclose(_f32(h), _f32(hr), atol=1e-5, rtol=0.05)


def _fma(x, y, z):
    """x * y + z rounded once to f32, as the kernel's fmaf: the product
    is exact in f64, the sum rounded to f64 then to f32."""
    return (x.double() * y.double() + z.double()).float()


def _chunked_rglru_scan(a, bx, steps=4, lanes=32):
    """The RG-LRU scan in the CUDA kernel's order: tiles of lanes * steps
    steps; each lane scans its sub-chunk of `steps` steps from zero into
    (prod a, h), the lanes' pairs are combined by a Kogge-Stone scan over
    the lanes, the exclusive prefix applied to the carry gives the state
    entering each sub-chunk, and each lane runs its sub-chunk again from
    it.  Steps past S scan as a = 1, bx = 0.  -> (hs in a's type, h_last
    f32)."""
    B, S, W = a.shape
    tile = steps * lanes
    pad = (-S) % tile
    af = torch.cat([a.float(), torch.ones(B, pad, W)], 1)
    bf = torch.cat([bx.float(), torch.zeros(B, pad, W)], 1)
    hs = torch.empty_like(af)
    carry = torch.zeros(B, W)
    for t0 in range(0, S + pad, tile):
        at = af[:, t0:t0 + tile].reshape(B, lanes, steps, W)
        bt = bf[:, t0:t0 + tile].reshape(B, lanes, steps, W)
        A, H = at[:, :, 0].clone(), bt[:, :, 0].clone()
        for i in range(1, steps):
            H = _fma(at[:, :, i], H, bt[:, :, i])
            A = A * at[:, :, i]
        d = 1
        while d < lanes:                  # every lane reads before any writes
            A_new, H_new = A.clone(), H.clone()
            H_new[:, d:] = _fma(A[:, d:], H[:, :-d], H[:, d:])
            A_new[:, d:] = A[:, d:] * A[:, :-d]
            A, H = A_new, H_new
            d *= 2
        h = torch.cat([carry[:, None],
                       _fma(A[:, :-1], carry[:, None], H[:, :-1])], 1)
        out = torch.empty_like(at)
        for i in range(steps):
            h = _fma(at[:, :, i], h, bt[:, :, i])
            out[:, :, i] = h
        hs[:, t0:t0 + tile] = out.reshape(B, tile, W)
        carry = h[:, -1]
    return hs[:, :S].to(a.dtype), carry


def _scan_inputs_near_one(B, S, W, seed):
    """recurrentgemma's regime: a uniform in [0.9, 0.9999], so products of
    a over a sub-chunk stay near 1 and carries reach far."""
    g = np.random.default_rng(seed)
    a = g.uniform(0.9, 0.9999, (B, S, W)).astype(np.float32)
    bx = (g.standard_normal((B, S, W)) * 0.3).astype(np.float32)
    return a, bx


# (B, S, W, a close to 1, dtype): S = 4097 with a in [0.9, 0.9999], S not
# a multiple of the 128-step tile, S below a sub-chunk, bf16
CHUNKED_CASES = [(1, 4097, 64, True, "float32"),
                 (2, 300, 96, False, "float32"),
                 (3, 37, 32, True, "float32"),
                 (1, 3, 64, False, "float32"),
                 (2, 515, 64, True, "bfloat16")]


@pytest.mark.parametrize("B,S,W,near_one,dtype", CHUNKED_CASES)
def test_chunked_scan_order_meets_the_tolerance(needs_jax, B, S, W,
                                                near_one, dtype):
    """The CUDA kernel's combine order (tiles of 128 steps, 32 sub-chunks
    of 4, a Kogge-Stone combine) emulated on the CPU: within the scan's
    tolerance of the plain version and of the Pallas kernel (interpret
    mode)."""
    a, bx = (_scan_inputs_near_one if near_one else _scan_inputs)(
        B, S, W, seed=S + W)
    ta, tbx = _to_torch(a, dtype), _to_torch(bx, dtype)
    got_y, got_h = _chunked_rglru_scan(ta, tbx)
    assert got_y.dtype == ta.dtype and got_h.shape == (B, W)
    ja, jbx = _to_jax(a, dtype), _to_jax(bx, dtype)
    wants = [jax_rglru_scan(ja, jbx, bw=W, interpret=True),
             ref.rglru_scan_ref(ta, tbx)]
    tol = 1e-5 if dtype == "float32" else 5e-2
    for wy, wh in wants:
        np.testing.assert_allclose(_f32(got_y), _f32(wy), atol=tol,
                                   rtol=0.05)
        np.testing.assert_allclose(_f32(got_h), _f32(wh), atol=tol,
                                   rtol=0.05)


def _chunked_rglru_scan_bwd(a, hs, dhs, dh_last, steps=4, lanes=32):
    """The RG-LRU backward in the CUDA kernel's order: the reverse scan
    g_t = a_{t+1} g_{t+1} + dhs_t (a_S = 1, entering g = dh_last) in tiles
    of lanes * steps steps, the last first; each lane scans its sub-chunk
    from zero, latest step first, into (prod a, G), the lanes' maps are
    combined by a Kogge-Stone scan from lane 31 down, the exclusive one
    applied to the carry gives the g entering each sub-chunk, and each lane
    runs its sub-chunk again from it; d a = g h_{t-1}.  Steps at or past S
    scan as a = 1, dhs = 0.  -> (da, dbx) f32."""
    B, S, W = a.shape
    tile = steps * lanes
    pad = (-S) % tile
    alpha = torch.cat([a[:, 1:].float(), torch.ones(B, 1 + pad, W)], 1)
    beta = torch.cat([dhs.float(), torch.zeros(B, pad, W)], 1)
    h_prev = torch.cat([torch.zeros(B, 1, W), hs[:, :-1].float()], 1)
    dbx = torch.empty_like(beta)
    carry = dh_last.float().clone()
    for t0 in range(S + pad - tile, -1, -tile):
        at = alpha[:, t0:t0 + tile].reshape(B, lanes, steps, W)
        bt = beta[:, t0:t0 + tile].reshape(B, lanes, steps, W)
        A, G = at[:, :, -1].clone(), bt[:, :, -1].clone()
        for i in range(steps - 2, -1, -1):
            G = _fma(at[:, :, i], G, bt[:, :, i])
            A = A * at[:, :, i]
        d = 1
        while d < lanes:                  # every lane reads before any writes
            A_new, G_new = A.clone(), G.clone()
            G_new[:, :-d] = _fma(A[:, :-d], G[:, d:], G[:, :-d])
            A_new[:, :-d] = A[:, :-d] * A[:, d:]
            A, G = A_new, G_new
            d *= 2
        g = torch.cat([_fma(A[:, 1:], carry[:, None], G[:, 1:]),
                       carry[:, None]], 1)
        out = torch.empty_like(at)
        for i in range(steps - 1, -1, -1):
            g = _fma(at[:, :, i], g, bt[:, :, i])
            out[:, :, i] = g
        dbx[:, t0:t0 + tile] = out.reshape(B, tile, W)
        carry = g[:, 0]
    dbx = dbx[:, :S]
    return dbx * h_prev, dbx


# (B, S, W, a close to 1): S = 4097 with a in [0.9, 0.9999], S not a
# multiple of the 128-step tile, S = 1
CHUNKED_BWD_CASES = [(1, 4097, 32, True), (2, 300, 24, False),
                     (3, 37, 8, True), (1, 1, 16, False)]


@pytest.mark.parametrize("B,S,W,near_one", CHUNKED_BWD_CASES)
def test_chunked_backward_scan_order_meets_the_tolerance(B, S, W, near_one):
    """The backward kernel's combine order (tiles of 128 steps walked from
    the end, 32 sub-chunks of 4, a Kogge-Stone combine from the last lane)
    emulated on the CPU: within atol 1e-5 and rtol 0.05 of the plain
    backward, and within 1e-4 of each gradient's largest entry."""
    a, bx = (_scan_inputs_near_one if near_one else _scan_inputs)(
        B, S, W, seed=S + W)
    g = np.random.default_rng(S)
    dhs = torch.from_numpy(g.standard_normal((B, S, W)).astype(np.float32))
    dh = torch.from_numpy(g.standard_normal((B, W)).astype(np.float32))
    ta = torch.from_numpy(a)
    hs, _ = ref.rglru_scan_ref(ta, torch.from_numpy(bx))
    got = _chunked_rglru_scan_bwd(ta, hs, dhs, dh)
    want = ref.rglru_scan_bwd_ref(ta, hs, dhs, dh)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(_f32(g_), _f32(w_), atol=1e-5, rtol=0.05)
        assert (g_ - w_).abs().max() <= 1e-4 * w_.abs().max()


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``: on the int32 view, add half of the 13
    dropped bits and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the f32 attention kernel takes each product on the tensor
    cores: hi = tf32(x), lo = tf32(x - hi), hi.hi + (hi.lo + lo.hi) with
    f32 sums (every partial product is exact in f32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


def _mm_tf32(a, b):
    """a @ b as one TF32 tensor-core product."""
    return _tf32(a) @ _tf32(b)


def _attention_with(mm, q, k, v, window):
    """Causal windowed attention with both products (scores and P V) taken
    by ``mm``, the softmax in f32: the numerics of the f32 kernel."""
    B, S, H, d = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, S, Kv, H // Kv, d).permute(0, 2, 3, 1, 4)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                # (B, Kv, 1, d, S)
    scores = mm(qg, kt) * d ** -0.5
    pos = torch.arange(S)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    p = torch.softmax(torch.where(mask, scores, ref.NEG_INF), dim=-1)
    out = mm(p, v.permute(0, 2, 1, 3)[:, :, None])       # (B, Kv, G, S, dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, v.shape[-1])


# (B, S, H, Kv, d, window): the serving layer's heads (10 query heads over
# one K/V head of width 256) at a short S with the window inside it, and
# grouped heads at d = 48
SPLIT_CASES = [(1, 160, 10, 1, 256, 64), (2, 96, 6, 2, 48, 20)]


@pytest.mark.parametrize("B,S,H,Kv,d,window", SPLIT_CASES)
def test_3xtf32_split_meets_the_f32_tolerance(B, S, H, Kv, d, window):
    """The f32 kernel's products on the TF32 tensor cores, emulated: with
    the 3xTF32 split the result stays within 2e-5 of the plain version,
    with one TF32 product it does not (why the split is needed)."""
    q, k, v = (torch.from_numpy(x) for x in
               _attn_inputs(B, S, H, d, seed=d + S, Kv=Kv))
    want = ref.flash_attention_ref(q, k, v, window=window)
    split = _attention_with(_mm_3xtf32, q, k, v, window)
    torch.testing.assert_close(split, want, atol=2e-5, rtol=2e-5)
    one = _attention_with(_mm_tf32, q, k, v, window)
    assert not torch.allclose(one, want, atol=2e-5, rtol=2e-5)


def test_ptxas_report_reads_registers_and_spills(monkeypatch):
    """`build.ptxas_report` turns ptxas's ``-v`` output of a build into one
    row per kernel, template arguments spelled out."""
    from repro_torch.kernels import build
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_"
        "attention_kernelI13__nv_bfloat16Li32EEEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 248 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_"
        "attention_kernelIfLi8EEEvPKT_' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n")
    monkeypatch.setitem(build.ptxas_log, build.CSRC / "x.cu", log)
    assert build.ptxas_report("x.cu") == [
        {"kernel": "flash_attention_kernel<bf16, 32>", "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 248},
        {"kernel": "flash_attention_kernel<f32, 8>", "stack": 8,
         "spill_stores": 4, "spill_loads": 4, "registers": 128}]
    assert build.ptxas_report("not_built.cu") == []


def test_cpu_tensors_take_the_plain_versions_without_launching():
    q, k, v = (torch.from_numpy(x) for x in _attn_inputs(1, 20, 2, 8, 0))
    a, bx = (torch.from_numpy(x) for x in _scan_inputs(1, 20, 8, 0))
    before = dict(launches)
    assert torch.equal(flash_attention(q, k, v, window=4),
                       ref.flash_attention_ref(q, k, v, window=4))
    for got, want in zip(rglru_scan(a, bx), ref.rglru_scan_ref(a, bx)):
        assert torch.equal(got, want)
    assert launches == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """The CUDA kernels against their plain versions on the card: the JAX
    tests' parametrisations, ragged S (not a multiple of 16, 32 or 64)
    and W, grouped heads (Kv 1 and 2 under H 10 and 6) at head_dim 256
    (the serving path's MQA layout, at a short S), every output-width
    template (<= 32, 64, 128, 256), d = 48 and d not a multiple of 16
    bytes, windows shorter than a key tile, softcap, bf16 at head_dim 256,
    and each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    dev = torch.device("cuda")
    reset_launches()
    cases = [(B, S, H, H, d, w, c, dt) for B, S, H, d, w, c, dt in
             ATTN_CASES]
    cases += [(2, 100, 6, 2, 32, 16, 0.0, "float32"),
              (1, 4097 // 8, 10, 1, 256, 128, 0.0, "float32"),
              (1, 333, 10, 1, 256, 64, 0.0, "bfloat16"),
              (2, 70, 4, 4, 48, 0, 50.0, "float32"),
              (1, 77, 6, 2, 48, 8, 0.0, "float32"),
              (2, 200, 10, 2, 128, 0, 0.0, "float32"),
              (1, 130, 10, 1, 16, 0, 0.0, "float32"),
              (1, 300, 10, 1, 256, 5, 50.0, "float32"),
              (1, 50, 2, 1, 33, 0, 0.0, "float32"),
              (1, 333, 6, 2, 48, 20, 0.0, "bfloat16"),
              (1, 45, 3, 1, 20, 0, 0.0, "bfloat16"),
              (2, 99, 6, 1, 256, 17, 0.0, "bfloat16")]
    for i, (B, S, H, Kv, d, window, softcap, dtype) in enumerate(cases):
        q, k, v = (_to_torch(x, dtype).to(dev)
                   for x in _attn_inputs(B, S, H, d, seed=i, Kv=Kv))
        got = flash_attention(q, k, v, window=window, softcap=softcap)
        want = ref.flash_attention_ref(q, k, v, window=window,
                                       softcap=softcap)
        assert torch.isfinite(got.float()).all()
        tol = 2e-5 if dtype == "float32" else 3e-2
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    scans = [(B, S, W, dt) for B, S, W, _, dt in SCAN_CASES]
    scans += [(3, 37, 100, "float32"), (2, 1000, 2560, "float32"),
              (1, 5, 3, "bfloat16")]
    for i, (B, S, W, dtype) in enumerate(scans):
        a, bx = (_to_torch(x, dtype).to(dev)
                 for x in _scan_inputs(B, S, W, seed=i))
        y, h = rglru_scan(a, bx)
        yr, hr = ref.rglru_scan_ref(a, bx)
        tol = 1e-5 if dtype == "float32" else 5e-2
        torch.testing.assert_close(y.float(), yr.float(), atol=tol,
                                   rtol=0.05)
        torch.testing.assert_close(h, hr, atol=tol, rtol=0.05)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == len(cases)
    assert launches["rglru_scan"] == len(scans)


# (B, S, H, Kv, d, dv, window, softcap): the shapes the served
# architectures give the kernel, at a short S: MLA's (deepseek-v2: 128
# heads, d = qk_nope + qk_rope = 192, dv = v_head_dim = 128), a ragged
# d != dv, multi-head attention with Kv = H = 40 (qwen1.5-32b), and GQA
# 48/8 under a logit cap of 30 (grok-1)
SERVED_SHAPES = [(1, 200, 128, 128, 192, 128, 0, 0.0),
                 (2, 77, 4, 4, 192, 128, 0, 0.0),
                 (1, 45, 3, 1, 40, 24, 0, 0.0),
                 (1, 257, 40, 40, 128, 128, 0, 0.0),
                 (1, 130, 48, 8, 128, 128, 0, 30.0)]


def _mla_inputs(B, S, H, Kv, d, dv, seed):
    g = np.random.default_rng(seed)
    q = (g.standard_normal((B, S, H, d)) * 0.3).astype(np.float32)
    k = (g.standard_normal((B, S, Kv, d)) * 0.3).astype(np.float32)
    v = g.standard_normal((B, S, Kv, dv)).astype(np.float32)
    return q, k, v


def test_plain_attention_with_wider_keys_matches_jax_ref(needs_jax):
    """d != dv (MLA's keys are wider than its values): the plain version
    the CPU runs against the JAX package's reference."""
    q, k, v = _mla_inputs(2, 77, 4, 4, 192, 128, seed=1)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    want = jax_ref.flash_attention_ref(*(jnp.asarray(x) for x in (q, k, v)))
    assert got.shape == (2, 77, 4, 128)
    np.testing.assert_allclose(_f32(got), np.asarray(want), atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Kv,d,dv,window,softcap", SERVED_SHAPES)
def test_cuda_flash_attention_at_the_served_shapes(B, S, H, Kv, d, dv,
                                                   window, softcap):
    """The forward kernel at the served architectures' head shapes against
    its plain version on the card, float32 at 2e-5, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(x).to(dev)
               for x in _mla_inputs(B, S, H, Kv, d, dv, seed=S))
    reset_launches()
    got = flash_attention(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert launches["flash_attention"] == 1
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    assert got.shape == (B, S, H, dv) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 2048])
def test_cuda_flash_attention_holds_along_the_key_loop(window):
    """Values that share one large vector (as a prompt's repeated tokens
    do), so the output is large, over 4096 keys at head_dim 256: the
    output must not drift along the key loop.  When the output rode the
    tensor core's accumulate from tile to tile it lost ~4.5e-5 of itself
    after 4096 keys, beyond the 2e-5 relative tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    dev = torch.device("cuda")
    g = np.random.default_rng(11)
    q = g.standard_normal((1, 4096, 2, 256)).astype(np.float32)
    k = g.standard_normal((1, 4096, 2, 256)).astype(np.float32)
    v = (5.0 + 0.1 * g.standard_normal((1, 4096, 2, 256))).astype(
        np.float32)
    q, k, v = (torch.from_numpy(x).to(dev) for x in (q, k, v))
    got = flash_attention(q, k, v, window=window)
    want = ref.flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# (B, S, W, a close to 1, dtype, storage offset in elements): S = 1, S
# below a sub-chunk (4 steps) and below a tile (128), ragged W (not a
# multiple of 4 or 8, or of a block's 32 channels: the plain-load path), a
# in [0.9, 0.9999] at S = 4097, bf16, few channels and the serving width,
# and inputs that do not start on a 16-byte boundary (the plain-load path
# at any W)
CHUNKED_CUDA_CASES = [(1, 1, 64, False, "float32", 0),
                      (2, 3, 64, False, "float32", 0),
                      (2, 3, 40, False, "bfloat16", 0),
                      (1, 77, 37, False, "float32", 0),
                      (3, 130, 2561, False, "bfloat16", 0),
                      (2, 4097, 256, True, "float32", 0),
                      (1, 4097, 2560, True, "bfloat16", 0),
                      (4, 300, 2560, True, "float32", 0),
                      (2, 129, 2560, False, "bfloat16", 0),
                      (2, 200, 96, False, "float32", 1),
                      (1, 150, 64, True, "bfloat16", 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,near_one,dtype,shift", CHUNKED_CUDA_CASES)
def test_cuda_chunked_rglru_scan_matches_plain_version(B, S, W, near_one,
                                                       dtype, shift):
    """The chunked CUDA scan against its plain version on the card, at the
    scan's tolerance, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card, see README.md)")
    dev = torch.device("cuda")
    a, bx = (_scan_inputs_near_one if near_one else _scan_inputs)(
        B, S, W, seed=S * W + shift)

    def on_card(x):
        flat = torch.empty(shift + x.size, dtype=getattr(torch, dtype),
                           device=dev)
        flat[shift:] = _to_torch(x, dtype).reshape(-1).to(dev)
        return flat[shift:].view(B, S, W)

    ta, tbx = on_card(a), on_card(bx)
    reset_launches()
    y, h = rglru_scan(ta, tbx)
    torch.cuda.synchronize()
    assert launches["rglru_scan"] == 1
    yr, hr = ref.rglru_scan_ref(ta, tbx)
    tol = 1e-5 if dtype == "float32" else 5e-2
    assert torch.isfinite(y.float()).all()
    torch.testing.assert_close(y.float(), yr.float(), atol=tol, rtol=0.05)
    torch.testing.assert_close(h, hr, atol=tol, rtol=0.05)
