"""Decoder-only language model: dense (global attention), hybrid
(RG-LRU + local attention) and SSM (Mamba-1) architectures, for serving
and training.

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

Training: `LM.forward` takes an optional ``params`` dict, keyed by the
model's parameter names (``embed``, ``layers.3.attn.wq``, ...), in place
of its own parameters, so one model (even one on the ``meta`` device,
holding no weights) computes the loss of many clients' parameters
(`repro_torch.core.fl_step`).  ``remat=True`` wraps each layer in
``torch.utils.checkpoint`` (the JAX package checkpoints each group of
``block_pattern``): its activations are recomputed in the backward, so a
layer's kernels run twice forward (`remat_contexts`: only the recompute
writes the selective scan's chunk states).  `named_from_tree` /
`tree_from_named` carry parameter trees between the JAX package's layout
and these names, with leading dims (the federation's clients) or
without.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import without_chunk_states
from .attention import attn_decode, attn_forward, init_attn, init_attn_cache
from .config import ATTN, LOCAL, MAMBA, RGLRU, ArchConfig
from .mamba import init_mamba, init_mamba_cache, mamba_decode, mamba_forward
from .modules import init_mlp, mlp, rmsnorm
from .rglru import init_rglru, init_rglru_cache, rglru_decode, rglru_forward

Cache = List[Dict[str, torch.Tensor]]


def _check_supported(cfg: ArchConfig) -> None:
    item = "ROADMAP.md, queue 1, item 10"
    if cfg.use_mla:
        raise NotImplementedError(f"{cfg.name}: MLA attention is not ported "
                                  f"yet ({item})")
    if cfg.qkv_bias or cfg.qk_norm:
        raise NotImplementedError(f"{cfg.name}: qkv bias and qk-norm are not "
                                  f"ported yet ({item})")
    if cfg.num_experts:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported "
                                  f"yet ({item})")
    if cfg.num_codebooks > 1:
        raise NotImplementedError(f"{cfg.name}: multi-codebook audio heads "
                                  f"are not ported yet ({item})")
    for kind in cfg.layer_kinds():
        if kind not in (ATTN, LOCAL, RGLRU, MAMBA):
            raise ValueError(f"unknown layer kind {kind!r}")


def untrainable(cfg: ArchConfig) -> Optional[str]:
    """Why the port cannot train ``cfg`` yet (None: it can), naming the
    ROADMAP item.  Training runs every kind the port serves: dense, hybrid
    (RG-LRU and local attention) and SSM (Mamba) layers.  MoE, MLA, qkv
    bias / qk-norm and audio codebooks are not ported."""
    try:
        _check_supported(cfg)
    except NotImplementedError as e:
        return str(e)
    return None


def _params(tree: Mapping[str, torch.Tensor], trainable: bool
            ) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=trainable)
                             for k, v in tree.items()})


def _sub(params: Mapping[str, torch.Tensor], prefix: str
         ) -> Dict[str, torch.Tensor]:
    """The entries of ``params`` under ``prefix.``, without it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items()
            if k.startswith(prefix + ".")}


class Layer(nn.Module):
    """One residual layer: RMSNorm -> attention or RG-LRU -> residual ->
    RMSNorm -> gated MLP -> residual; a MAMBA layer is RMSNorm -> Mamba
    block -> residual, with no second norm and no MLP."""

    def __init__(self, cfg: ArchConfig, kind: str, generator, device,
                 trainable: bool = False):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        ones = lambda: nn.Parameter(torch.ones((cfg.d_model,), device=device),
                                    requires_grad=trainable)
        self.ln1 = ones()
        if kind == MAMBA:
            self.mamba = _params(init_mamba(cfg, generator, device=device),
                                 trainable)
            return
        self.ln2 = ones()
        if kind == RGLRU:
            self.rglru = _params(init_rglru(cfg, generator, device=device),
                                 trainable)
        else:
            self.attn = _params(init_attn(cfg, generator, device=device),
                                trainable)
        self.mlp = _params(init_mlp(cfg.d_model, cfg.d_ff, generator,
                                    device=device), trainable)

    @property
    def block(self) -> str:
        """The name of this layer's mixing block's parameters."""
        return {MAMBA: "mamba", RGLRU: "rglru"}.get(self.kind, "attn")

    def forward(self, x, cache_len: int = 0,
                params: Optional[Mapping[str, torch.Tensor]] = None):
        """cache_len > 0 (prefill) also returns this layer's decode cache.
        ``params`` (keys as this layer's parameter names: ``ln1``,
        ``rglru.w_x``, ...) replaces the layer's own parameters."""
        cfg, lcache = self.cfg, None
        if params is None:
            params = dict(self.named_parameters())
        blk = _sub(params, self.block)
        h = rmsnorm(params["ln1"], x)
        if self.kind == MAMBA:
            y = mamba_forward(blk, cfg, h, return_state=bool(cache_len))
        elif self.kind == RGLRU:
            y = rglru_forward(blk, cfg, h, return_state=bool(cache_len))
        else:
            y = attn_forward(blk, cfg, h, self.kind,
                             return_cache=bool(cache_len),
                             cache_len=cache_len)
        if cache_len:
            y, lcache = y
        x = x + y
        if self.kind != MAMBA:
            x = x + mlp(_sub(params, "mlp"), rmsnorm(params["ln2"], x),
                        cfg.activation)
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


def remat_contexts():
    """A layer checkpoint's two contexts: its first pass, whose saved
    tensors are dropped, writes no selective-scan chunk states; its
    recompute, which the backward uses, does."""
    return without_chunk_states(), contextlib.nullcontext()


class LM(nn.Module):
    """The language model of ``cfg`` in float32, its parameters drawn from
    ``seed`` with the JAX package's init scheme (``seed=None``: left
    uninitialised, for `params_from_numpy`).  Parameters require gradients
    only when built ``trainable`` (serving builds them frozen); training
    may instead hand `forward` a ``params`` dict."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 seed: Optional[int] = 0, trainable: bool = False):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        g = None
        if seed is not None:
            g = torch.Generator(device=device or "cpu").manual_seed(seed)
        emb = torch.empty((cfg.padded_vocab, cfg.d_model), device=device)
        if g is not None:
            emb.normal_(0.0, 0.02, generator=g)
        self.embed = nn.Parameter(emb, requires_grad=trainable)
        self.layers = nn.ModuleList(
            Layer(cfg, kind, g, device, trainable)
            for kind in cfg.layer_kinds())
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), device=device),
            requires_grad=trainable)
        if not cfg.tie_embeddings:
            head = torch.empty((cfg.d_model, cfg.padded_vocab),
                               device=device)
            if g is not None:
                head.normal_(0.0, 0.02, generator=g)
            self.lm_head = nn.Parameter(head, requires_grad=trainable)

    # -- embeddings ---------------------------------------------------- #
    def embed_tokens(self, tokens: torch.Tensor, embed=None) -> torch.Tensor:
        x = (self.embed if embed is None else embed)[tokens]
        if self.cfg.emb_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def unembed(self, x: torch.Tensor, params=None) -> torch.Tensor:
        cfg = self.cfg
        if params is None:
            head = self.embed.T if cfg.tie_embeddings else self.lm_head
        else:
            head = (params["embed"].T if cfg.tie_embeddings
                    else params["lm_head"])
        logits = x @ head
        if cfg.padded_vocab != cfg.vocab_size:
            ids = torch.arange(cfg.padded_vocab, device=logits.device)
            logits = torch.where(ids < cfg.vocab_size, logits,
                                 torch.tensor(-1e9, dtype=logits.dtype,
                                              device=logits.device))
        return logits

    # -- full sequence --------------------------------------------------- #
    def forward(self, tokens: torch.Tensor,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                remat: bool = False) -> torch.Tensor:
        """tokens (B,S) -> logits (B,S,V) at every position, with the
        model's own parameters or ``params`` (all of them, keyed by the
        model's parameter names).  ``remat`` recomputes each layer's
        activations in the backward.  (The JAX package's MoE auxiliary
        loss has no counterpart: no MoE here.)"""
        if params is None:
            params = dict(self.named_parameters())
        x = self.embed_tokens(tokens, params["embed"])
        for i, layer in enumerate(self.layers):
            lp = _sub(params, f"layers.{i}")
            if remat:
                x = checkpoint(layer, x, 0, lp, use_reentrant=False,
                               context_fn=remat_contexts)
            else:
                x = layer(x, params=lp)
        return self.unembed(rmsnorm(params["final_norm"], x), params)

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


def _index(a, lead: int, g: int):
    return a[(slice(None),) * lead + (g,)]


def unstack_layers(tree: Mapping[str, Any], cfg: ArchConfig,
                   lead: int = 0) -> List[Any]:
    """A JAX ``{"prefix", "groups", "suffix"}`` tree (parameters or cache)
    -> one entry per layer: ``groups[j]`` leaves indexed at g (after
    ``lead`` leading dims) give layer len(prefix) + g * len(block_pattern)
    + j."""
    pre, groups, suf = _split_depth(cfg)
    pat = len(cfg.block_pattern)
    layers: List[Any] = [None] * cfg.num_layers
    for i, lp in zip(pre, tree["prefix"]):
        layers[i] = lp
    for j, stacked in enumerate(tree["groups"]):
        for g in range(groups):
            layers[len(pre) + g * pat + j] = _map(
                stacked, lambda a, g=g: _index(a, lead, g))
    for i, lp in zip(suf, tree["suffix"]):
        layers[i] = lp
    return layers


def named_from_tree(tree: Mapping[str, Any], cfg: ArchConfig,
                    lead: int = 0) -> Dict[str, Any]:
    """The JAX package's parameter tree (``init_params``' layout; ``lead``
    leading dims on every leaf, as a federation's (NC, C) or (NC,)) -> a
    flat dict keyed by the port's parameter names (``embed``,
    ``layers.0.ln1``, ``layers.2.attn.wq``, ...), leaves untouched."""
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        out["lm_head"] = tree["lm_head"]
    for i, lp in enumerate(unstack_layers(tree, cfg, lead)):
        for k, v in lp.items():
            if isinstance(v, Mapping):
                out.update({f"layers.{i}.{k}.{kk}": vv
                            for kk, vv in v.items()})
            else:
                out[f"layers.{i}.{k}"] = v
    return out


def tree_from_named(named: Mapping[str, Any], cfg: ArchConfig,
                    lead: int = 0) -> Dict[str, Any]:
    """The inverse of `named_from_tree` over numpy arrays (tensors are
    copied to the host): the JAX package's tree, each group's layers
    stacked at axis ``lead``."""
    arr = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
           else np.asarray(v) for k, v in named.items()}
    layers: List[Dict[str, Any]] = [{} for _ in range(cfg.num_layers)]
    for k, v in arr.items():
        if not k.startswith("layers."):
            continue
        _, i, rest = k.split(".", 2)
        node = layers[int(i)]
        if "." in rest:
            sub, leaf = rest.split(".", 1)
            node.setdefault(sub, {})[leaf] = v
        else:
            node[rest] = v
    pre, groups, suf = _split_depth(cfg)
    pat = len(cfg.block_pattern)
    stack = lambda *xs: np.stack(xs, axis=lead)
    tree = {"embed": arr["embed"], "final_norm": arr["final_norm"],
            "prefix": [layers[i] for i in pre],
            "groups": [_zip_map([layers[len(pre) + g * pat + j]
                                 for g in range(groups)], stack)
                       for j in range(pat)] if groups else [],
            "suffix": [layers[i] for i in suf]}
    if not cfg.tie_embeddings:
        tree["lm_head"] = arr["lm_head"]
    return tree


def _zip_map(trees: List[Any], fn):
    if isinstance(trees[0], Mapping):
        return {k: _zip_map([t[k] for t in trees], fn) for k in trees[0]}
    return fn(*trees)


def params_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig, *,
                      device=None, trainable: bool = False) -> LM:
    """The JAX package's ``init_params`` tree, as numpy arrays -> an `LM`
    holding the same numbers."""
    model = LM(cfg, device=device, seed=None, trainable=trainable)
    mine = dict(model.named_parameters())
    theirs = named_from_tree(tree, cfg)
    if set(mine) != set(theirs):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(mine) ^ set(theirs))}")
    with torch.no_grad():
        for k, dst in mine.items():
            src = np.asarray(theirs[k])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{k}: shape {src.shape} does not fit "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, copy=True)))
    return model


def params_to_numpy(model: LM) -> Dict[str, Any]:
    """The inverse of `params_from_numpy`: the model's parameters as the
    JAX package's ``init_params`` tree of numpy arrays."""
    return tree_from_named(dict(model.named_parameters()), model.cfg)
