"""Decoder-only language model: dense (global attention), hybrid
(RG-LRU + local attention) and SSM (Mamba-1) architectures, for serving.

The JAX package's ``models/transformer.py`` keeps its layers as an
unrolled prefix, a ``lax.scan`` over stacked groups of ``block_pattern``
and an unrolled suffix.  The port holds every layer in one ``ModuleList``
(26 for recurrentgemma-2b, 64 for falcon-mamba-7b); `params_from_numpy`
unstacks the JAX package's parameter tree into it, and `unstack_layers`
does the same for caches.  MoE, MLA, qkv-bias or qk-norm and
multi-codebook audio models raise `NotImplementedError`.

A decode cache is a list with one dict per layer: ``{"k", "v", "pos"}``
for attention (a ring buffer for LOCAL layers), ``{"h", "conv"}`` for
RG-LRU and Mamba.  `LM.decode_step` updates it in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .attention import attn_decode, attn_forward, init_attn, init_attn_cache
from .config import ATTN, LOCAL, MAMBA, RGLRU, ArchConfig
from .mamba import init_mamba, init_mamba_cache, mamba_decode, mamba_forward
from .modules import init_mlp, mlp, rmsnorm
from .rglru import init_rglru, init_rglru_cache, rglru_decode, rglru_forward

Cache = List[Dict[str, torch.Tensor]]


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: MLA attention is not ported "
                                  "yet (ROADMAP queue 1, item 10)")
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError(f"{cfg.name}: qkv bias and qk-norm are not "
                                  "ported yet (ROADMAP queue 1, item 10)")
    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported "
                                  "yet (ROADMAP queue 1, item 10)")
    if cfg.num_codebooks > 1:
        raise NotImplementedError(f"{cfg.name}: multi-codebook audio heads "
                                  "are not ported yet (ROADMAP queue 1, "
                                  "item 10)")
    for kind in cfg.layer_kinds():
        if kind not in (ATTN, LOCAL, RGLRU, MAMBA):
            raise ValueError(f"unknown layer kind {kind!r}")


def _params(tree: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tree.items()})


class Layer(nn.Module):
    """One residual layer: RMSNorm -> attention or RG-LRU -> residual ->
    RMSNorm -> gated MLP -> residual; a MAMBA layer is RMSNorm -> Mamba
    block -> residual, with no second norm and no MLP."""

    def __init__(self, cfg: ArchConfig, kind: str, generator, device):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        ones = lambda: nn.Parameter(torch.ones((cfg.d_model,), device=device),
                                    requires_grad=False)
        self.ln1 = ones()
        if kind == MAMBA:
            self.mamba = _params(init_mamba(cfg, generator, device=device))
            return
        self.ln2 = ones()
        if kind == RGLRU:
            self.rglru = _params(init_rglru(cfg, generator, device=device))
        else:
            self.attn = _params(init_attn(cfg, generator, device=device))
        self.mlp = _params(init_mlp(cfg.d_model, cfg.d_ff, generator,
                                    device=device))

    def forward(self, x, cache_len: int = 0):
        """cache_len > 0 (prefill) also returns this layer's decode cache."""
        cfg, lcache = self.cfg, None
        h = rmsnorm(self.ln1, x)
        if self.kind == MAMBA:
            y = mamba_forward(self.mamba, cfg, h, return_state=bool(cache_len))
        elif self.kind == RGLRU:
            y = rglru_forward(self.rglru, cfg, h, return_state=bool(cache_len))
        else:
            y = attn_forward(self.attn, cfg, h, self.kind,
                             return_cache=bool(cache_len),
                             cache_len=cache_len)
        if cache_len:
            y, lcache = y
        x = x + y
        if self.kind != MAMBA:
            x = x + mlp(self.mlp, rmsnorm(self.ln2, x), cfg.activation)
        return (x, lcache) if cache_len else x

    def decode(self, x, lcache, step: int):
        cfg = self.cfg
        h = rmsnorm(self.ln1, x)
        if self.kind == MAMBA:
            y, lcache = mamba_decode(self.mamba, cfg, h, lcache, step)
        elif self.kind == RGLRU:
            y, lcache = rglru_decode(self.rglru, cfg, h, lcache, step)
        else:
            y, lcache = attn_decode(self.attn, cfg, h, lcache, step,
                                    self.kind)
        x = x + y
        if self.kind != MAMBA:
            x = x + mlp(self.mlp, rmsnorm(self.ln2, x), cfg.activation)
        return x, lcache

    def init_cache(self, batch: int, max_len: int):
        dev = self.ln1.device
        if self.kind == MAMBA:
            return init_mamba_cache(self.cfg, batch, device=dev)
        if self.kind == RGLRU:
            return init_rglru_cache(self.cfg, batch, device=dev)
        return init_attn_cache(self.cfg, batch, max_len, self.kind,
                               device=dev)


class LM(nn.Module):
    """The language model of ``cfg`` in float32, its parameters drawn from
    ``seed`` with the JAX package's init scheme (``seed=None``: left
    uninitialised, for `params_from_numpy`).  Parameters do not require
    gradients: the port serves and does not train yet."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 seed: Optional[int] = 0):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        g = None
        if seed is not None:
            g = torch.Generator(device=device or "cpu").manual_seed(seed)
        emb = torch.empty((cfg.padded_vocab, cfg.d_model), device=device)
        if g is not None:
            emb.normal_(0.0, 0.02, generator=g)
        self.embed = nn.Parameter(emb, requires_grad=False)
        self.layers = nn.ModuleList(
            Layer(cfg, kind, g, device)
            for kind in cfg.layer_kinds())
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), device=device), requires_grad=False)
        if not cfg.tie_embeddings:
            head = torch.empty((cfg.d_model, cfg.padded_vocab),
                               device=device)
            if g is not None:
                head.normal_(0.0, 0.02, generator=g)
            self.lm_head = nn.Parameter(head, requires_grad=False)

    # -- embeddings ---------------------------------------------------- #
    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens]
        if self.cfg.emb_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        logits = x @ (self.embed.T if cfg.tie_embeddings else self.lm_head)
        if cfg.padded_vocab != cfg.vocab_size:
            ids = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(ids < cfg.vocab_size, logits,
                                 torch.tensor(-1e9, dtype=logits.dtype,
                                              device=logits.device))
        return logits

    # -- full sequence --------------------------------------------------- #
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B,S) -> logits (B,S,V) at every position.  (The JAX
        package's MoE auxiliary loss has no counterpart: no MoE here.)"""
        x = self.embed_tokens(tokens)
        for layer in self.layers:
            x = layer(x)
        return self.unembed(rmsnorm(self.final_norm, x))

    def prefill(self, tokens: torch.Tensor, cache_len: int):
        """Serving prefill: run the whole prompt, return the last position's
        logits (B,V) and a decode-ready cache (ring-buffer KV of the last
        positions, recurrent states).

        The JAX package's ``q_chunk`` (query chunking that bounds the score
        tensor in device memory) has no counterpart: the flash-attention
        kernel never materialises the scores, whatever S."""
        x = self.embed_tokens(tokens)
        cache: Cache = []
        for layer in self.layers:
            x, lc = layer(x, cache_len=cache_len)
            cache.append(lc)
        x = rmsnorm(self.final_norm, x[:, -1:])
        return self.unembed(x)[:, 0], cache

    # -- decode ---------------------------------------------------------- #
    def init_cache(self, batch: int, max_len: int) -> Cache:
        """An empty decode cache: K/V in bfloat16 (ring buffers of the
        window for LOCAL layers), RG-LRU and Mamba states in float32."""
        return [layer.init_cache(batch, max_len) for layer in self.layers]

    def decode_step(self, cache: Cache, tokens: torch.Tensor, step: int):
        """One-token decode.  tokens: (B,); step: the absolute position.
        Returns (logits (B,V), cache), the cache updated in place."""
        x = self.embed_tokens(tokens[:, None])
        for layer, lc in zip(self.layers, cache):
            x, _ = layer.decode(x, lc, step)
        x = rmsnorm(self.final_norm, x)
        return self.unembed(x)[:, 0], cache


# --------------------------------------------------------------------- #
# interchange with the JAX package's trees
# --------------------------------------------------------------------- #
def _split_depth(cfg: ArchConfig):
    """-> (prefix layer indices, group count, suffix layer indices): the
    JAX package's layer organisation."""
    pat = len(cfg.block_pattern)
    pre = cfg.first_dense_layers
    groups = (cfg.num_layers - pre) // pat
    return (list(range(pre)), groups,
            list(range(pre + groups * pat, cfg.num_layers)))


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(tree: Mapping[str, Any], cfg: ArchConfig) -> List[Any]:
    """A JAX ``{"prefix", "groups", "suffix"}`` tree (parameters or cache)
    -> one entry per layer: ``groups[j]`` leaves indexed at g give layer
    len(prefix) + g * len(block_pattern) + j."""
    pre, groups, suf = _split_depth(cfg)
    pat = len(cfg.block_pattern)
    layers: List[Any] = [None] * cfg.num_layers
    for i, lp in zip(pre, tree["prefix"]):
        layers[i] = lp
    for j, stacked in enumerate(tree["groups"]):
        for g in range(groups):
            layers[len(pre) + g * pat + j] = _map(stacked,
                                                  lambda a, g=g: a[g])
    for i, lp in zip(suf, tree["suffix"]):
        layers[i] = lp
    return layers


def params_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig, *,
                      device=None) -> LM:
    """The JAX package's ``init_params`` tree, as numpy arrays -> an `LM`
    holding the same numbers."""
    model = LM(cfg, device=device, seed=None)

    def put(dst: torch.Tensor, src) -> None:
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {src.shape} does not fit {dst.shape}")
        dst.copy_(torch.from_numpy(np.array(src, copy=True)))

    with torch.no_grad():
        put(model.embed, tree["embed"])
        put(model.final_norm, tree["final_norm"])
        if not cfg.tie_embeddings:
            put(model.lm_head, tree["lm_head"])
        for layer, lp in zip(model.layers, unstack_layers(tree, cfg)):
            put(layer.ln1, lp["ln1"])
            if layer.kind == MAMBA:
                blocks = ("mamba",)
            else:
                put(layer.ln2, lp["ln2"])
                blocks = ("rglru" if layer.kind == RGLRU else "attn", "mlp")
            for sub in blocks:
                mine = getattr(layer, sub)
                if set(mine.keys()) != set(lp[sub].keys()):
                    raise ValueError(f"{sub}: keys {sorted(lp[sub])} != "
                                     f"{sorted(mine.keys())}")
                for k in mine.keys():
                    put(mine[k], lp[sub][k])
    return model

