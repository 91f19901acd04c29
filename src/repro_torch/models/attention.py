"""Attention blocks: GQA/MQA/MHA with optional logit softcap and sliding
window.  (The JAX package's MLA, qkv bias and qk-norm are not ported: the
model raises for configs that use them.)

Two paths per block, as in the JAX package's ``models/attention.py``:
  * `attn_forward` — full-sequence causal attention (prefill), through the
    flash-attention kernel (`kernels.ops.attention`), which takes the K/V
    heads as they are (no repeat) and never writes the scores out;
  * `attn_decode`  — one query against the (ring-buffer) KV cache with
    plain PyTorch ops, as the JAX package's decode does (there is no
    kernel for it).

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
from .modules import apply_rope, dense_init, softcap

NEG_INF = -2.0e38
CACHE_DTYPE = torch.bfloat16    # K/V cache entries, as in the JAX package


def init_attn(cfg: ArchConfig, generator: Optional[torch.Generator], *,
              device=None) -> Dict[str, torch.Tensor]:
    hd, D = cfg.head_dim, cfg.d_model
    return {
        "wq": dense_init((D, cfg.num_heads * hd), generator, device=device),
        "wk": dense_init((D, cfg.num_kv_heads * hd), generator,
                         device=device),
        "wv": dense_init((D, cfg.num_kv_heads * hd), generator,
                         device=device),
        "wo": dense_init((cfg.num_heads * hd, D), generator, device=device),
    }


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


def _project_qkv(p: Mapping[str, torch.Tensor], cfg: ArchConfig, x):
    B, S = x.shape[:2]
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _ring_cache(k, v, Wc: int) -> Dict[str, torch.Tensor]:
    """Pack the last Wc (roped) keys/values into ring-buffer slot order so
    decode can continue: slot = position % Wc."""
    B, S = k.shape[:2]
    take = min(S, Wc)
    tail_pos = torch.arange(S - take, S, device=k.device)
    slots = tail_pos % Wc
    ck = torch.zeros((B, Wc) + tuple(k.shape[2:]), dtype=CACHE_DTYPE,
                     device=k.device)
    cv = torch.zeros((B, Wc) + tuple(v.shape[2:]), dtype=CACHE_DTYPE,
                     device=v.device)
    ck[:, slots] = k[:, S - take:].to(CACHE_DTYPE)
    cv[:, slots] = v[:, S - take:].to(CACHE_DTYPE)
    cpos = torch.full((Wc,), -1, dtype=torch.int32, device=k.device)
    cpos[slots] = tail_pos.to(torch.int32)
    return {"k": ck, "v": cv, "pos": cpos}


def cache_width(cfg: ArchConfig, kind: str, max_len: int) -> int:
    return min(max_len, cfg.window) if (kind == LOCAL and cfg.window) \
        else max_len


def attn_forward(p, cfg: ArchConfig, x, kind: str,
                 return_cache: bool = False, cache_len: int = 0):
    """x: (B,S,D) -> (B,S,D) [, the decode cache of the last positions].

    One launch of the flash-attention kernel on a card.  The JAX package's
    ``q_chunk`` has no counterpart: the kernel never holds more than one
    tile of scores."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    window = cfg.window if kind == LOCAL else 0
    out = ops.attention(q, k, v, window=window, softcap=cfg.attn_softcap)
    y = out.reshape(B, S, -1) @ p["wo"]
    if not return_cache:
        return y
    return y, _ring_cache(k, v, cache_width(cfg, kind, cache_len))


def init_attn_cache(cfg: ArchConfig, batch: int, max_len: int, kind: str,
                    device=None):
    Wc = cache_width(cfg, kind, max_len)
    shape = (batch, Wc, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "pos": torch.full((Wc,), -1, dtype=torch.int32, device=device)}


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
