"""Attention blocks: GQA/MQA/MHA (optional qkv bias, qk-norm, logit
softcap and sliding window) and DeepSeek-style MLA (multi-head latent
attention).

Two paths per block, as in the JAX package's ``models/attention.py``:
  * `attn_forward` / `mla_forward` — full-sequence causal attention
    (prefill), through the flash-attention kernel (`kernels.ops.attention`),
    which takes the K/V heads as they are (no repeat) and never writes the
    scores out.  MLA expands its latent into per-head keys of width
    qk_nope + qk_rope and values of width v_head_dim, so the kernel runs
    with d != dv; its scale d ** -0.5 is MLA's (qk_nope + qk_rope) ** -0.5;
  * `attn_decode` / `mla_decode` — one query against the (ring-buffer)
    cache with plain PyTorch ops, as the JAX package's decode does (there
    is no kernel for it).  MLA caches the normalised latent and the roped
    shared key (``{"ckv", "krope", "pos"}``) and decodes either with the
    absorbed matrices (``cfg.mla_absorbed``: attention in the latent
    space) or by expanding K/V from the latent at every step.

Sharded training (``shards``, `repro_torch.core.sharding.Shards`): the
projections hold this rank's columns of the flat heads x head_dim dims, so
the kernel runs on the rank's own query heads and the K/V heads they read,
and ``wo``'s rows give a partial output summed over the tensor-parallel
axes.  Where the query heads do not split whole over those axes (10 heads
over 4 ranks), the projections are gathered and the kernel runs every
head, then each rank keeps its columns of the output; where the K/V heads
do not (one K/V head), they are gathered and each rank takes those its
query heads read.  Unsharded (no ``shards``) the same body runs, every
collective the identity.

The KV cache of a LOCAL (sliding-window) layer is a ring buffer of width
``window``; stored absolute positions (init -1) drive the validity mask,
and RoPE is applied at write time with absolute positions, so relative
offsets stay right across the wrap.  Parameters are a mapping of tensors
(an ``nn.ParameterDict`` in the model) with the JAX package's names.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..kernels import ops
from .config import LOCAL, ArchConfig
from .modules import apply_rope, dense_init, rmsnorm, share, softcap

NEG_INF = -2.0e38
CACHE_DTYPE = torch.bfloat16    # K/V cache entries, as in the JAX package


def init_attn(cfg: ArchConfig, generator: Optional[torch.Generator], *,
              device=None) -> Dict[str, torch.Tensor]:
    if cfg.use_mla:
        return _init_mla(cfg, generator, device)
    hd, D = cfg.head_dim, cfg.d_model
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    p = {"wq": dense_init((D, H * hd), generator, device=device),
         "wk": dense_init((D, Kv * hd), generator, device=device),
         "wv": dense_init((D, Kv * hd), generator, device=device),
         "wo": dense_init((H * hd, D), generator, device=device)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H * hd,), device=device)
        p["bk"] = torch.zeros((Kv * hd,), device=device)
        p["bv"] = torch.zeros((Kv * hd,), device=device)
    if cfg.qk_norm:
        p["qnorm"] = torch.ones((hd,), device=device)
        p["knorm"] = torch.ones((hd,), device=device)
    return p


def _init_mla(cfg: ArchConfig, generator, device):
    D, H = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = {}
    if cfg.q_lora_rank:
        p["wq_a"] = dense_init((D, cfg.q_lora_rank), generator, device=device)
        p["q_norm"] = torch.ones((cfg.q_lora_rank,), device=device)
        p["wq_b"] = dense_init((cfg.q_lora_rank, H * qk), generator,
                               device=device)
    else:
        p["wq"] = dense_init((D, H * qk), generator, device=device)
    p["wkv_a"] = dense_init((D, cfg.kv_lora_rank + cfg.qk_rope_dim),
                            generator, device=device)
    p["kv_norm"] = torch.ones((cfg.kv_lora_rank,), device=device)
    p["wkv_b"] = dense_init(
        (cfg.kv_lora_rank, H * (cfg.qk_nope_dim + cfg.v_head_dim)),
        generator, device=device)
    p["wo"] = dense_init((H * cfg.v_head_dim, D), generator, device=device)
    return p


def sdpa(q, k, v, mask, scale: float, cap: float):
    """Plain grouped-head attention (decode).  q: (B,S,H,d), k: (B,T,Kv,d),
    v: (B,T,Kv,dv); mask broadcastable to (B,Kv,g,S,T) or None.  The
    weights take v's dtype before the product, as in the JAX package."""
    B, S, H, dq = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, S, Kv, H // Kv, dq)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = softcap(scores, cap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, v.shape[-1])


def _project_qkv(p: Mapping[str, torch.Tensor], cfg: ArchConfig, x,
                 sh=None, ax=(), whole=(True, True)):
    """q, k, v of (B,S,heads,head_dim): the bias added before the heads
    split, qk-norm (RMSNorm over head_dim, per head) after it; RoPE comes
    later, after the norm.  In a sharded step (``sh``) the projections
    hold this rank's columns over ``ax``; those whose heads do not split
    whole (``whole``: the query's, the K/V's) are gathered to all of
    them."""
    B, S = x.shape[:2]
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if not whole[0]:
        q = sh.gather(q, -1, ax)
    if not whole[1]:
        k, v = sh.gather(k, -1, ax), sh.gather(v, -1, ax)
    q = q.reshape(B, S, -1, cfg.head_dim)
    k = k.reshape(B, S, -1, cfg.head_dim)
    v = v.reshape(B, S, -1, cfg.head_dim)
    if cfg.qk_norm:
        q, k = rmsnorm(p["qnorm"], q), rmsnorm(p["knorm"], k)
    return q, k, v


def _ring_cache(Wc: int, **entries: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Pack the last Wc positions of each (B,S,...) entry (roped keys,
    values, MLA latents) into ring-buffer slot order so decode can
    continue: slot = position % Wc."""
    first = next(iter(entries.values()))
    B, S, dev = first.shape[0], first.shape[1], first.device
    take = min(S, Wc)
    tail_pos = torch.arange(S - take, S, device=dev)
    slots = tail_pos % Wc
    out = {}
    for name, t in entries.items():
        c = torch.zeros((B, Wc) + tuple(t.shape[2:]), dtype=CACHE_DTYPE,
                        device=dev)
        c[:, slots] = t[:, S - take:].to(CACHE_DTYPE)
        out[name] = c
    cpos = torch.full((Wc,), -1, dtype=torch.int32, device=dev)
    cpos[slots] = tail_pos.to(torch.int32)
    out["pos"] = cpos
    return out


def cache_width(cfg: ArchConfig, kind: str, max_len: int) -> int:
    return min(max_len, cfg.window) if (kind == LOCAL and cfg.window) \
        else max_len


def _kv_for(k, v, H: int, Kv: int, h0: int, Hl: int):
    """Whole K/V heads (B,S,Kv,d) -> those the query heads [h0, h0 + Hl)
    read, in the kernel's grouping (local query head i reads K/V head
    i // (Hl / Kl)); a repeat per query head where no grouping fits."""
    g = H // Kv
    lo, hi = h0 // g, (h0 + Hl - 1) // g + 1
    kl = hi - lo
    if Hl % kl == 0 and all((h0 + i) // g - lo == i // (Hl // kl)
                            for i in range(Hl)):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.tensor([(h0 + i) // g for i in range(Hl)], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def attn_forward(p, cfg: ArchConfig, x, kind: str,
                 return_cache: bool = False, cache_len: int = 0,
                 shards=None):
    """x: (B,S,D) -> (B,S,D) [, the decode cache of the last positions].

    One launch of the flash-attention kernel on a card.  The JAX package's
    ``q_chunk`` has no counterpart: the kernel never holds more than one
    tile of scores.  ``shards``: this rank's share of a sharded training
    step (module notes)."""
    B, S, _ = x.shape
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    sh = share(shards)
    ax = sh.axes("wq", 1)
    n = sh.size(ax)
    if return_cache and n > 1:
        raise ValueError("a sharded attention returns no cache: the "
                         "serving plans are not ported (ROADMAP.md)")
    whole_q = H % n == 0
    whole_kv = whole_q and Kv % n == 0
    q, k, v = _project_qkv(p, cfg, x, sh, ax, (whole_q, whole_kv))
    Hl = q.shape[2]                     # the query heads this rank runs
    h0 = sh.index(ax) * Hl if whole_q else 0
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    kr, vr = (k, v) if whole_kv else _kv_for(k, v, H, Kv, h0, Hl)
    window = cfg.window if kind == LOCAL else 0
    out = ops.attention(q, kr, vr, window=window, softcap=cfg.attn_softcap)
    out = out.reshape(B, S, -1)
    if not whole_q:
        out = sh.chunk(out, -1, ax)     # this rank's rows of wo
    y = sh.reduce(out @ p["wo"], ax)
    if not return_cache:
        return y
    return y, _ring_cache(cache_width(cfg, kind, cache_len), k=k, v=v)


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, kind: str,
                    device=None):
    Wc = cache_width(cfg, kind, max_len)
    pos = torch.full((Wc,), -1, dtype=torch.int32, device=device)
    if cfg.use_mla:
        return {"ckv": torch.zeros((batch, Wc, cfg.kv_lora_rank),
                                   dtype=CACHE_DTYPE, device=device),
                "krope": torch.zeros((batch, Wc, cfg.qk_rope_dim),
                                     dtype=CACHE_DTYPE, device=device),
                "pos": pos}
    shape = (batch, Wc, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "pos": pos}


def attn_decode(p, cfg: ArchConfig, x, cache, step: int, kind: str):
    """x: (B,1,D); step: the absolute position.  Returns (y, cache); the
    cache's tensors are updated in place (one slot of the ring)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x)
    at = torch.tensor([step], device=x.device)
    q = apply_rope(q, at, cfg.rope_theta)
    k = apply_rope(k, at, cfg.rope_theta)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = step % ck.shape[1]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    cpos[slot] = step
    valid = (cpos >= 0) & (cpos <= step)
    if kind == LOCAL and cfg.window > 0:
        valid &= cpos > step - cfg.window
    out = sdpa(q, ck, cv, valid, cfg.head_dim ** -0.5, cfg.attn_softcap)
    y = out.reshape(B, 1, -1).to(p["wo"].dtype) @ p["wo"]
    return y, cache


# --------------------------------------------------------------------- #
# MLA
# --------------------------------------------------------------------- #
def _mla_q(p, cfg: ArchConfig, x, regroup=None):
    """-> (q_nope, q_rope), (B,S,H,qk_nope) and (B,S,H,qk_rope), unroped;
    ``regroup`` (a sharded step's) maps the flat heads x dims first."""
    B, S = x.shape[:2]
    if cfg.q_lora_rank:
        q = rmsnorm(p["q_norm"], x @ p["wq_a"]) @ p["wq_b"]
    else:
        q = x @ p["wq"]
    if regroup is not None:
        q = regroup(q)
    q = q.reshape(B, S, -1, cfg.qk_nope_dim + cfg.qk_rope_dim)
    return q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]


def _mla_latent(p, cfg: ArchConfig, x, pos):
    """-> (c_kv (B,S,r) normalised, k_rope (B,S,1,qk_rope) roped at
    ``pos``): what the cache keeps of each position."""
    ckv = x @ p["wkv_a"]
    r = cfg.kv_lora_rank
    c_kv = rmsnorm(p["kv_norm"], ckv[..., :r])
    k_rope = apply_rope(ckv[..., None, r:], pos, cfg.rope_theta)
    return c_kv, k_rope


def _mla_scale(cfg: ArchConfig) -> float:
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def mla_forward(p, cfg: ArchConfig, x, kind: str,
                return_cache: bool = False, cache_len: int = 0,
                shards=None):
    """x: (B,S,D) -> (B,S,D) [, the latent cache of the last positions].

    K and V are expanded from the latent for every head; one launch of
    the flash-attention kernel with d = qk_nope + qk_rope and dv =
    v_head_dim.  MLA layers attend globally whatever ``kind``, as in the
    JAX package.  ``shards``: this rank's share of a sharded training
    step: the latent and the low-rank query are replicated, ``wq_b`` (or
    ``wq``) and ``wkv_b`` hold this rank's heads, gathered to all of them
    where the heads do not split whole (module notes)."""
    B, S, _ = x.shape
    nope = cfg.qk_nope_dim
    sh = share(shards)
    ax = sh.axes("wq_b" if cfg.q_lora_rank else "wq", 1)
    n = sh.size(ax)
    if return_cache and n > 1:
        raise ValueError("a sharded attention returns no cache: the "
                         "serving plans are not ported (ROADMAP.md)")
    whole = cfg.num_heads % n == 0
    regroup = None if whole else (lambda t: sh.gather(t, -1, ax))
    pos = torch.arange(S, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, regroup)
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    c_kv, k_rope = _mla_latent(p, cfg, x, pos)
    kv = c_kv @ p["wkv_b"]
    if not whole:
        kv = regroup(kv)
    Hl = q_nope.shape[2]
    kv = kv.reshape(B, S, Hl, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   k_rope.expand(B, S, Hl, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = ops.attention(q, k, kv[..., nope:], softcap=cfg.attn_softcap)
    out = out.reshape(B, S, -1)
    if not whole:
        out = sh.chunk(out, -1, ax)
    y = sh.reduce(out @ p["wo"], ax)
    if not return_cache:
        return y
    return y, _ring_cache(cache_len, ckv=c_kv, krope=k_rope[:, :, 0])


def _mla_step(p, cfg: ArchConfig, x, cache, step: int):
    """The part both decodes share: this position's query, and its latent
    and roped key written into the cache's slot (in place).  -> (q_nope,
    q_rope, the cache's valid positions)."""
    at = torch.tensor([step], device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x)
    q_rope = apply_rope(q_rope, at, cfg.rope_theta)
    c_kv, k_rope = _mla_latent(p, cfg, x, at)
    cc, cr, cpos = cache["ckv"], cache["krope"], cache["pos"]
    slot = step % cc.shape[1]
    cc[:, slot] = c_kv[:, 0].to(cc.dtype)
    cr[:, slot] = k_rope[:, 0, 0].to(cr.dtype)
    cpos[slot] = step
    return q_nope, q_rope, (cpos >= 0) & (cpos <= step)


def mla_decode_absorbed(p, cfg: ArchConfig, x, cache, step: int):
    """Absorbed-matrix decode: W_UK folds into the query and W_UV into the
    output, so attention runs in the latent space (H * Wc * r products a
    token, not Wc * r * H * (nope + v) to expand K/V)."""
    B, H, r = x.shape[0], cfg.num_heads, cfg.kv_lora_rank
    q_nope, q_rope, valid = _mla_step(p, cfg, x, cache, step)
    wkv_b = p["wkv_b"].reshape(r, H, cfg.qk_nope_dim + cfg.v_head_dim)
    w_uk, w_uv = wkv_b[..., :cfg.qk_nope_dim], wkv_b[..., cfg.qk_nope_dim:]
    q_eff = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    c = cache["ckv"].to(x.dtype)                              # (B,Wc,r)
    s = (torch.einsum("bhr,btr->bht", q_eff, c)
         + torch.einsum("bhd,btd->bht", q_rope[:, 0],
                        cache["krope"].to(x.dtype)))
    s = softcap(s.to(torch.float32) * _mla_scale(cfg), cfg.attn_softcap)
    s = torch.where(valid[None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(x.dtype)                  # (B,H,Wc)
    ctx = torch.einsum("bht,btr->bhr", w, c)
    out = torch.einsum("bhr,rhv->bhv", ctx, w_uv)
    return out.reshape(B, 1, -1) @ p["wo"], cache


def mla_decode(p, cfg: ArchConfig, x, cache, step: int, kind: str):
    """x: (B,1,D); step: the absolute position.  Returns (y, cache), the
    cache updated in place: the absorbed form when ``cfg.mla_absorbed``,
    else K/V expanded from every cached latent (the JAX package's
    reference form)."""
    if cfg.mla_absorbed:
        return mla_decode_absorbed(p, cfg, x, cache, step)
    B, H, nope = x.shape[0], cfg.num_heads, cfg.qk_nope_dim
    q_nope, q_rope, valid = _mla_step(p, cfg, x, cache, step)
    Wc = cache["ckv"].shape[1]
    kv = (cache["ckv"].to(x.dtype) @ p["wkv_b"]).reshape(
        B, Wc, H, nope + cfg.v_head_dim)
    k = torch.cat([kv[..., :nope],
                   cache["krope"].to(x.dtype)[:, :, None, :].expand(
                       B, Wc, H, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(q, k, kv[..., nope:], valid, _mla_scale(cfg),
               cfg.attn_softcap)
    return out.reshape(B, 1, -1) @ p["wo"], cache
