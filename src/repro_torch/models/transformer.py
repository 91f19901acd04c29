"""Decoder-only language model over every architecture of the JAX
package: dense / GQA / MQA / MHA attention (with qkv bias or qk-norm),
MLA, sliding-window attention, MoE MLPs (after ``first_dense_layers``
dense ones), Mamba-1 SSM blocks, RG-LRU recurrent blocks and
multi-codebook audio heads, for serving and training.

The JAX package's ``models/transformer.py`` keeps its layers as an
unrolled prefix, a ``lax.scan`` over stacked groups of ``block_pattern``
and an unrolled suffix.  The port holds every layer in one ``ModuleList``
(26 for recurrentgemma-2b, 64 for falcon-mamba-7b); `params_from_numpy`
unstacks the JAX package's parameter tree into it, and `unstack_layers`
does the same for caches.

Audio (``num_codebooks`` K > 1): the embedding is (K, V, D) and the head
(K, D, V); tokens are (B, K, S), the K codebook embeddings of a position
are summed, and logits are (B, K, S, V) ((B, K, V) from prefill and
decode, whose tokens are (B, K)).

A decode cache is a list with one dict per layer: ``{"k", "v", "pos"}``
for attention (a ring buffer for LOCAL layers), ``{"ckv", "krope",
"pos"}`` for MLA, ``{"h", "conv"}`` for RG-LRU and Mamba.
`LM.decode_step` updates it in place.

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
and these names (``layers.5.moe.shared.wg``: a nested dict of the JAX
tree is a dotted name), with leading dims (the federation's clients) or
without.  `LM.forward_aux` also returns the MoE layers' summed Switch
loss, the JAX package's ``forward(...)[1]``.

Sharding: `param_specs` is the JAX package's rule book for a device mesh
(tensor parallelism on ``model``, FSDP or expert parallelism on
``data``), one spec a leaf: a tuple with one entry a dim, each a mesh axis
name, None or a tuple of axis names (the counterpart of a
``PartitionSpec``).  ``LM.forward(..., shards=...)`` runs the model on a
rank's shards of those parameters (`repro_torch.core.sharding`): the
kernels see the rank's own heads or channels, and the collectives between
blocks are written out.

Every kind trains: dense (qkv bias and qk-norm included), hybrid, SSM,
MoE, MLA and audio.  Under the checkpoint an MoE layer's recompute must
route every token as its first pass did, or the backward would
differentiate another dispatch than the forward ran: it does, because the
routing depends only on the layer's input and every op on the way
(attention kernel, router product, top-k, cumsum) is deterministic
(`repro_torch.models.moe`).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels import without_chunk_states
from .attention import (attn_decode, attn_forward, decode_position, init_attn,
                        init_attn_cache, mla_decode, mla_forward)
from .config import ATTN, LOCAL, MAMBA, RGLRU, ArchConfig
from .mamba import init_mamba, init_mamba_cache, mamba_decode, mamba_forward
from .modules import init_mlp, mlp, rmsnorm, share, sub_params
from .moe import init_moe, moe_forward
from .rglru import init_rglru, init_rglru_cache, rglru_decode, rglru_forward

Cache = List[Dict[str, torch.Tensor]]


def _check_supported(cfg: ArchConfig) -> None:
    for kind in cfg.layer_kinds():
        if kind not in (ATTN, LOCAL, RGLRU, MAMBA):
            raise ValueError(f"unknown layer kind {kind!r}")


def _params(tree: Mapping[str, Any], trainable: bool) -> nn.ParameterDict:
    """A (nested) dict of tensors -> parameters; a sub-dict becomes a
    nested ``ParameterDict``, so its names are dotted (``moe.shared.wg``)."""
    return nn.ParameterDict({
        k: _params(v, trainable) if isinstance(v, Mapping)
        else nn.Parameter(v, requires_grad=trainable)
        for k, v in tree.items()})


class Layer(nn.Module):
    """One residual layer: RMSNorm -> attention (MLA when ``cfg.use_mla``)
    or RG-LRU -> residual -> RMSNorm -> gated MLP, or the MoE block in an
    attention layer past ``first_dense_layers`` -> residual; a MAMBA layer
    is RMSNorm -> Mamba block -> residual, with no second norm and no
    MLP."""

    def __init__(self, cfg: ArchConfig, kind: str, index: int, generator,
                 device, trainable: bool = False):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.is_moe = (bool(cfg.num_experts) and kind in (ATTN, LOCAL)
                       and index >= cfg.first_dense_layers)
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
        if self.is_moe:
            self.moe = _params(init_moe(cfg, generator, device=device),
                               trainable)
        else:
            self.mlp = _params(init_mlp(cfg.d_model, cfg.d_ff, generator,
                                        device=device), trainable)

    @property
    def block(self) -> str:
        """The name of this layer's mixing block's parameters."""
        return {MAMBA: "mamba", RGLRU: "rglru"}.get(self.kind, "attn")

    def _ffn(self, p, h, shards=None):
        """The MLP or MoE block on ``h`` with its parameters ``p`` -> (its
        output, its aux loss or None)."""
        if self.is_moe:
            return moe_forward(p, self.cfg, h, shards=shards)
        return mlp(p, h, self.cfg.activation, shards), None

    def forward(self, x, cache_len: int = 0,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                shards=None):
        """-> (x, aux, lcache): ``aux`` the MoE block's Switch loss (None
        without one), ``lcache`` this layer's decode cache when cache_len
        > 0 (prefill), else None.  ``params`` (keys as this layer's
        parameter names: ``ln1``, ``rglru.w_x``, ...) replaces the layer's
        own parameters; ``shards`` (this layer's view) makes them this
        rank's shards of a sharded training step."""
        cfg, aux, lcache = self.cfg, None, None
        if params is None:
            params = dict(self.named_parameters())
        blk = sub_params(params, self.block)
        sh = share(shards)
        bsh = sh.sub(self.block)
        h = rmsnorm(params["ln1"], x)
        if self.kind == MAMBA:
            y = mamba_forward(blk, cfg, h, return_state=bool(cache_len),
                              shards=bsh)
        elif self.kind == RGLRU:
            y = rglru_forward(blk, cfg, h, return_state=bool(cache_len),
                              shards=bsh)
        else:
            fwd = mla_forward if cfg.use_mla else attn_forward
            y = fwd(blk, cfg, h, self.kind, return_cache=bool(cache_len),
                    cache_len=cache_len, shards=bsh)
        if cache_len:
            y, lcache = y
        x = x + y
        if self.kind != MAMBA:
            name = "moe" if self.is_moe else "mlp"
            y, aux = self._ffn(sub_params(params, name),
                               rmsnorm(params["ln2"], x),
                               sh.sub(name))
            x = x + y
        return x, aux, lcache

    def decode(self, x, lcache, step: int,
               params: Optional[Mapping[str, torch.Tensor]] = None,
               shards=None):
        """One token through the layer, its cache updated in place.
        ``params`` and ``shards`` as in `forward`: this rank's shards of
        the parameters and of the cache (`cache_specs`)."""
        cfg = self.cfg
        if params is None:
            params = dict(self.named_parameters())
        blk = sub_params(params, self.block)
        sh = share(shards)
        bsh = sh.sub(self.block)
        h = rmsnorm(params["ln1"], x)
        if self.kind == MAMBA:
            y, lcache = mamba_decode(blk, cfg, h, lcache, step, shards=bsh)
        elif self.kind == RGLRU:
            y, lcache = rglru_decode(blk, cfg, h, lcache, step, shards=bsh)
        else:
            dec = mla_decode if cfg.use_mla else attn_decode
            y, lcache = dec(blk, cfg, h, lcache, step, self.kind,
                            shards=bsh)
        x = x + y
        if self.kind != MAMBA:
            name = "moe" if self.is_moe else "mlp"
            y, _ = self._ffn(sub_params(params, name),
                             rmsnorm(params["ln2"], x), sh.sub(name))
            x = x + y
        return x, lcache

    def init_cache(self, batch: int, max_len: int):
        dev = self.ln1.device
        if self.kind == MAMBA:
            return init_mamba_cache(self.cfg, batch, device=dev)
        if self.kind == RGLRU:
            return init_rglru_cache(self.cfg, batch, device=dev)
        return init_attn_cache(self.cfg, batch, max_len, self.kind,
                               device=dev)


def _gathered_layer(layer: Layer, x, lp, i: int, sh):
    """Layer ``i`` on its parameters ``lp`` (this rank's shards), gathered
    to their compute layouts here: inside a checkpoint, so only the shards
    are saved (`LM.forward_aux`)."""
    pre = f"layers.{i}"
    return layer(x, params=sh.use(lp, pre), shards=sh.sub(pre))


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
        books = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
        emb = torch.empty(books + (cfg.padded_vocab, cfg.d_model),
                          device=device)
        if g is not None:
            emb.normal_(0.0, 0.02, generator=g)
        self.embed = nn.Parameter(emb, requires_grad=trainable)
        self.layers = nn.ModuleList(
            Layer(cfg, kind, i, g, device, trainable)
            for i, kind in enumerate(cfg.layer_kinds()))
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), device=device),
            requires_grad=trainable)
        if not cfg.tie_embeddings:
            head = torch.empty(books + (cfg.d_model, cfg.padded_vocab),
                               device=device)
            if g is not None:
                head.normal_(0.0, 0.02, generator=g)
            self.lm_head = nn.Parameter(head, requires_grad=trainable)

    # -- embeddings ---------------------------------------------------- #
    def _vocab_axes(self, shards) -> tuple:
        """The mesh axes the vocab of the embedding splits over."""
        return share(shards).axes("embed",
                                  1 if self.cfg.num_codebooks > 1 else 0)

    def embed_tokens(self, tokens: torch.Tensor, embed=None,
                     shards=None) -> torch.Tensor:
        """(B,S) ids, or (B,K,S) for K codebooks (their embeddings summed)
        -> (B,S,D).  ``shards``: ``embed`` holds this rank's vocab rows;
        each rank looks up the ids it holds (zeros elsewhere) and the
        lookups are summed."""
        embed = self.embed if embed is None else embed
        sh = share(shards)
        ax = self._vocab_axes(sh)
        if ax:
            n = embed.shape[-2]
            ids = tokens - sh.index(ax) * n
            inside = (ids >= 0) & (ids < n)
            tokens = torch.where(inside, ids, torch.zeros_like(ids))
        if self.cfg.num_codebooks > 1:
            books = torch.arange(embed.shape[0], device=tokens.device)
            x = embed[books[None, :, None], tokens]
            if ax:
                x = x * inside[..., None].to(x.dtype)
            x = x.sum(dim=1)
        else:
            x = embed[tokens]
            if ax:
                x = x * inside[..., None].to(x.dtype)
        x = sh.reduce(x, ax)
        if self.cfg.emb_scale:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype)
        return x

    def unembed(self, x: torch.Tensor, params=None,
                shards=None) -> torch.Tensor:
        """(B,S,D) -> logits (B,S,V), or (B,K,S,V) for K codebooks;
        ``shards``: this rank's vocab columns of them (`vocab_offset`)."""
        cfg = self.cfg
        if params is None:
            params = {"embed": self.embed}
            if not cfg.tie_embeddings:
                params["lm_head"] = self.lm_head
        if cfg.num_codebooks > 1:
            logits = (torch.einsum("bsd,kvd->bksv", x, params["embed"])
                      if cfg.tie_embeddings else
                      torch.einsum("bsd,kdv->bksv", x, params["lm_head"]))
        else:
            logits = x @ (params["embed"].T if cfg.tie_embeddings
                          else params["lm_head"])
        if cfg.padded_vocab != cfg.vocab_size:
            ids = torch.arange(logits.shape[-1], device=logits.device) + \
                self.vocab_offset(logits.shape[-1], shards)
            logits = torch.where(ids < cfg.vocab_size, logits,
                                 torch.tensor(-1e9, dtype=logits.dtype,
                                              device=logits.device))
        return logits

    def vocab_offset(self, n_local: int, shards=None) -> int:
        """The first vocab id of this rank's ``n_local`` logits."""
        sh = share(shards)
        return sh.index(self._vocab_axes(sh)) * n_local

    # -- full sequence --------------------------------------------------- #
    def forward(self, tokens: torch.Tensor,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                remat: bool = False) -> torch.Tensor:
        """tokens (B,S) (or (B,K,S)) -> logits (B,S,V) (or (B,K,S,V)) at
        every position, with the model's own parameters or ``params`` (all
        of them, keyed by the model's parameter names).  ``remat``
        recomputes each layer's activations in the backward."""
        return self.forward_aux(tokens, params, remat)[0]

    def forward_aux(self, tokens: torch.Tensor,
                    params: Optional[Mapping[str, torch.Tensor]] = None,
                    remat: bool = False, shards=None):
        """`forward` -> (logits, aux): aux the MoE layers' summed Switch
        load-balance loss, float32 (0 without MoE layers), as the JAX
        package's ``forward``.  ``shards``
        (`repro_torch.core.sharding.Shards`): ``params`` are this rank's
        shards of a sharded training step, the logits its vocab columns.

        With the at-rest specs (``shards.rest``) a layer's FSDP'd leaves
        are gathered inside the function its checkpoint wraps (the JAX
        package's gathers inside ``jax.checkpoint`` of its group body): the
        checkpoint saves the shards, the gathered leaves die with the
        layer's first pass, and the recompute gathers them again.  The
        embedding is gathered for the lookup and the head for the
        unembedding (a tied embedding once, for both)."""
        if params is None:
            params = dict(self.named_parameters())
        sh = share(shards)
        emb = sh.use({"embed": params["embed"]})["embed"]
        x = self.embed_tokens(tokens, emb, sh)
        if not self.cfg.tie_embeddings:
            emb = None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            lp = sub_params(params, f"layers.{i}")
            if remat:
                # the recompute routes an MoE layer's tokens as the first
                # pass did: same input, deterministic ops (module notes)
                x, a, _ = checkpoint(_gathered_layer, layer, x, lp, i, sh,
                                     use_reentrant=False,
                                     context_fn=remat_contexts)
            else:
                x, a, _ = _gathered_layer(layer, x, lp, i, sh)
            if a is not None:
                aux = aux + a
        head = {"final_norm": params["final_norm"]}
        head.update({"embed": emb} if emb is not None else
                    sh.use({"lm_head": params["lm_head"]}))
        return self.unembed(rmsnorm(head["final_norm"], x), head, sh), aux

    def prefill(self, tokens: torch.Tensor, cache_len: int,
                params: Optional[Mapping[str, torch.Tensor]] = None,
                shards=None):
        """Serving prefill: run the whole prompt, return the last position's
        logits (B,V) (or (B,K,V)) and a decode-ready cache (ring-buffer KV
        or MLA latents of the last positions, recurrent states).

        The JAX package's ``q_chunk`` (query chunking that bounds the score
        tensor in device memory) has no counterpart: the flash-attention
        kernel never materialises the scores, whatever S.

        ``params`` / ``shards`` (`repro_torch.core.sharding.Shards` with
        the parameters' at-rest specs, ``rest``): this rank's shards of the
        parameters and its rows of ``tokens`` (over ``shards.tokens``).  A
        layer's FSDP'd leaves are gathered as the layer runs and dropped
        after it; the cache is this rank's shards at `cache_specs`'
        layout, and the logits are whole on every rank."""
        sh = share(shards)
        params = dict(self.named_parameters()) if params is None else params
        x = self.embed_tokens(tokens, sh.use({"embed": params["embed"]})[
            "embed"], sh)
        cache: Cache = []
        for i, layer in enumerate(self.layers):
            pre = f"layers.{i}"
            x, _, lc = layer(x, cache_len=cache_len,
                             params=sh.use(sub_params(params, pre), pre),
                             shards=sh.sub(pre))
            cache.append(lc)
        return self._whole_logits(x[:, -1:], params, sh), cache

    def _whole_logits(self, x, params, sh):
        """(B_local,1,D) -> the last logits (B,V) (or (B,K,V)) of the
        whole batch on every rank: this rank's vocab columns gathered over
        the vocab's axes, its rows over the tokens' axes."""
        keys = ["final_norm", "embed"] + (
            [] if self.cfg.tie_embeddings else ["lm_head"])
        head = sh.use({k: params[k] for k in keys})
        logits = self.unembed(rmsnorm(head["final_norm"], x), head, sh)
        logits = sh.gather(logits, -1, self._vocab_axes(sh))
        logits = logits[:, :, 0] if self.cfg.num_codebooks > 1 else \
            logits[:, 0]
        return sh.gather(logits, 0, sh.tokens)

    def init_cache(self, batch: int, max_len: int) -> Cache:
        """An empty decode cache: K/V and MLA latents in bfloat16 (ring
        buffers of the window for LOCAL layers), RG-LRU and Mamba states
        in float32."""
        return [layer.init_cache(batch, max_len) for layer in self.layers]

    def decode_step(self, cache: Cache, tokens: torch.Tensor, step: int,
                    params: Optional[Mapping[str, torch.Tensor]] = None,
                    shards=None):
        """One-token decode.  tokens: (B,), or (B,K) for K codebooks; step:
        the absolute position.  Returns (logits (B,V) or (B,K,V), cache),
        the cache updated in place.  ``params`` / ``shards`` as in
        `prefill`: this rank's shards, rows and cache, the logits whole."""
        sh = share(shards)
        params = dict(self.named_parameters()) if params is None else params
        x = self.embed_tokens(tokens[..., None], sh.use(
            {"embed": params["embed"]})["embed"], sh)
        step = decode_position(step, x.device)
        for i, (layer, lc) in enumerate(zip(self.layers, cache)):
            pre = f"layers.{i}"
            x, _ = layer.decode(x, lc, step,
                                params=sh.use(sub_params(params, pre), pre),
                                shards=sh.sub(pre))
        return self._whole_logits(x, params, sh), cache


def seeded_params(cfg: ArchConfig, seed: int, *, device=None,
                  keep=None) -> Dict[str, torch.Tensor]:
    """``LM(cfg, device=device, seed=seed)``'s parameters, the same
    numbers drawn in the same order, one layer at a time: ``keep(name,
    tensor)`` (e.g. this rank's shard of it, a copy) is applied to each
    leaf of a layer before the next layer is drawn, so a rank of a mesh
    holds its shards and one layer whole at most, never the model."""
    keep = keep or (lambda name, t: t)
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    books = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    out = {"embed": keep("embed", torch.empty(
        books + (cfg.padded_vocab, cfg.d_model), device=device).normal_(
            0.0, 0.02, generator=g))}
    for i, kind in enumerate(cfg.layer_kinds()):
        layer = Layer(cfg, kind, i, g, device)
        for k, v in layer.named_parameters():
            out[f"layers.{i}.{k}"] = keep(f"layers.{i}.{k}", v.detach())
        del layer
    out["final_norm"] = keep("final_norm",
                             torch.ones((cfg.d_model,), device=device))
    if not cfg.tie_embeddings:
        out["lm_head"] = keep("lm_head", torch.empty(
            books + (cfg.d_model, cfg.padded_vocab), device=device).normal_(
                0.0, 0.02, generator=g))
    return out


@functools.lru_cache(maxsize=16)
def structure(cfg: ArchConfig) -> LM:
    """The model of ``cfg`` on the ``meta`` device (no weights), one a
    config: the layers' kinds and names for a step that runs on
    parameters it is handed, and the shapes of a plan."""
    return LM(cfg, device="meta", seed=None)


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


def layer_groups(cfg: ArchConfig, names) -> List[Tuple[str, ...]]:
    """The JAX package's stacked leaves among the parameter names
    ``names``: for each block position j of ``cfg.block_pattern`` and each
    leaf path <rest>, the G names ``layers.{i}.<rest>`` with i =
    len(prefix) + g * len(block_pattern) + j, g = 0 .. G-1, in g's order.
    Prefix and suffix layers, ``embed``, ``lm_head`` and ``final_norm`` are
    in no group."""
    pre, groups, _ = _split_depth(cfg)
    pat = len(cfg.block_pattern)
    first, last = len(pre), len(pre) + groups * pat
    out: Dict[Tuple[int, str], List[str]] = {}
    for k in names:
        parts = k.split(".")
        if parts[0] != "layers" or not first <= int(parts[1]) < last:
            continue
        j = (int(parts[1]) - first) % pat
        out.setdefault((j, ".".join(parts[2:])), []).append(k)
    return [tuple(sorted(v, key=lambda k: int(k.split(".")[1])))
            for v in out.values()]


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


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[f"{prefix}{k}"] = v


def named_from_tree(tree: Mapping[str, Any], cfg: ArchConfig,
                    lead: int = 0) -> Dict[str, Any]:
    """The JAX package's parameter tree (``init_params``' layout; ``lead``
    leading dims on every leaf, as a federation's (NC, C) or (NC,)) -> a
    flat dict keyed by the port's parameter names (``embed``,
    ``layers.0.ln1``, ``layers.2.attn.wq``, ``layers.1.moe.shared.wg``,
    ...), leaves untouched."""
    out = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    if not cfg.tie_embeddings:
        out["lm_head"] = tree["lm_head"]
    for i, lp in enumerate(unstack_layers(tree, cfg, lead)):
        _flatten(lp, f"layers.{i}.", out)
    return out


def tree_from_named(named: Mapping[str, Any], cfg: ArchConfig,
                    lead: int = 0) -> Dict[str, Any]:
    """The inverse of `named_from_tree` over numpy arrays (tensors are
    copied to the host): the JAX package's tree, each group's layers
    stacked at axis ``lead``.  A value may be a dict of arrays (an
    optimizer's per-leaf moments), stacked entry by entry."""
    host = lambda v: (v.detach().cpu().numpy()                  # noqa
                      if isinstance(v, torch.Tensor) else np.asarray(v))
    arr = {k: _map(v, host) for k, v in named.items()}
    layers: List[Dict[str, Any]] = [{} for _ in range(cfg.num_layers)]
    for k, v in arr.items():
        if not k.startswith("layers."):
            continue
        _, i, *path, leaf = k.split(".")
        node = layers[int(i)]
        for sub in path:
            node = node.setdefault(sub, {})
        node[leaf] = v
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


# --------------------------------------------------------------------- #
# sharding specs
# --------------------------------------------------------------------- #
_COL = {"wq", "wk", "wv", "wg", "wu", "in_proj", "w_x", "w_gate"}  # (D, out)
_ROW = {"wo", "wd", "out_proj", "w_out"}                           # (in, D)
_VEC_TP = {"bq", "bk", "bv", "conv_b", "b_a", "b_i", "dt_bias", "D", "lam"}


def _base_spec(keys, name, audio, tp, fsdp, ep, shard_experts) -> tuple:
    """The JAX package's ``_base_spec``: the trailing dims' spec of the
    leaf ``name`` at path ``keys``.

    tp   -- tensor-parallel axis: heads / d_ff / vocab / channels
    fsdp -- contracting-dim (ZeRO-style) axis of dense weights (fsdp_tp)
    ep   -- expert-parallel axis of the MoE expert weights (ep_tp)"""
    # the shared experts' MLP under moe/shared is a plain 2-D MLP
    in_moe = "moe" in keys and "shared" not in keys
    if name == "embed":
        return (None, tp, fsdp) if audio else (tp, fsdp)
    if name == "lm_head":
        return (None, fsdp, tp) if audio else (fsdp, tp)
    if in_moe and name in ("wg", "wu"):
        if ep and shard_experts:
            return (ep, None, tp)
        if ep:                      # E not divisible by ep: d_ff 2-D
            return (None, None, (ep, tp))
        if fsdp:
            return (None, fsdp, tp)
        return (tp, None, None) if shard_experts else (None, None, tp)
    if in_moe and name == "wd":
        if ep and shard_experts:
            return (ep, None, tp)
        if ep:
            return (None, (ep, tp), None)
        if fsdp:
            return (None, tp, fsdp)
        return (tp, None, None) if shard_experts else (None, tp, None)
    if name == "router":
        return (None, None)
    if name in _COL:
        return (fsdp, tp)
    if name in _ROW:
        return (tp, fsdp)
    if name in ("wq_a", "wkv_a"):
        return (fsdp, None)
    if name in ("wq_b", "wkv_b", "dt_proj", "w_a", "w_i"):
        return (None, tp)
    if name in ("x_proj", "A_log"):
        return (tp, None)
    if name == "conv_w":
        return (None, tp)
    if name in _VEC_TP:
        return (tp,)
    return (None,)


def _ndim(leaf) -> int:
    return len(tuple(leaf.shape))


def _map_with_keys(tree, fn, keys=()):
    """``fn(keys, leaf)`` over a (nested) dict or list; a dotted key of a
    flat dict (``layers.3.moe.wg``) counts as its parts."""
    if isinstance(tree, Mapping):
        return {k: _map_with_keys(v, fn, keys + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_keys(v, fn, keys + (i,))
                for i, v in enumerate(tree)]
    return fn(keys, tree)


def param_specs(params, cfg: ArchConfig, *, tp="model", fsdp=None,
                stack_axis=None, leading=(), tp_size=16, ep_size=16):
    """The JAX package's ``param_specs``: one spec (a tuple, an entry a
    dim) a leaf of ``params``, the port's named parameters (``embed``,
    ``layers.3.attn.wq``, ...; any leaf with a ``shape``: meta tensors
    do) or `tree_from_named`'s tree, whose structure it keeps.

    tp      -- mesh axis of tensor parallelism (heads / d_ff / vocab)
    fsdp    -- the ``data``-like axis: FSDP of dense weights under
               ``fsdp_tp``, experts under ``ep_tp``
    stack_axis -- shards the layer-stack dim of a ``groups`` leaf of the
               JAX tree (the named parameters have one leaf a layer, and
               no stack dim to shard)
    leading -- mesh axes of the first len(leading) dims: mode A's
               (cluster, client) dims ``('pod', 'data')``, mode B's
               ``('pod',)``
    tp_size, ep_size -- the axes' sizes: whether the experts divide them
               decides between sharding experts and d_ff"""
    ep = fsdp if cfg.shard_scheme == "ep_tp" else None
    dense_fsdp = fsdp if cfg.shard_scheme == "fsdp_tp" else None
    shard_experts = bool(cfg.num_experts) and bool(
        (ep and ep_size and cfg.num_experts % ep_size == 0)
        or (not ep and not dense_fsdp and tp_size
            and cfg.num_experts % tp_size == 0))

    def spec(keys, leaf):
        name = next((k for k in reversed(keys) if isinstance(k, str)
                     and not k.isdigit()), None)
        nd = _ndim(leaf)
        base = list(_base_spec(keys, name, cfg.num_codebooks > 1, tp,
                               dense_fsdp, ep, shard_experts))
        while len(base) < nd:
            base.insert(0, None)
        base = base[:nd]
        if stack_axis and keys and keys[0] == "groups":
            g = len(leading)
            if g < nd and base[g] is None:
                base[g] = stack_axis
        for i, ax in enumerate(leading):
            if i < nd and base[i] is None:
                base[i] = ax
        return tuple(base)

    return _map_with_keys(params, spec)


def cache_specs(cache, *, batch_axis="data", kv_axis=None, seq_axis=None,
                state_axis=None, attn_seq_axis=None):
    """The JAX package's ``cache_specs``: one spec a leaf of a decode
    cache (the port's list of per-layer dicts, or any nesting of dicts and
    lists of leaves with a ``shape``), by the leaf's name.  The JAX
    package's stacked-group dim has no counterpart: the port keeps a cache
    a layer (`unstack_layers` maps the JAX package's onto it).

    batch_axis    -- the batch dim (None for long_500k's batch of 1)
    kv_axis       -- the K/V-head dim of attention caches (when divisible)
    seq_axis      -- the sequence (slot) dim of MLA's ``ckv`` / ``krope``
    state_axis    -- the channel dim of RG-LRU / Mamba ``h`` and ``conv``
    attn_seq_axis -- the slot dim of attention K/V caches where the K/V
                     head count does not divide the model axis: the
                     context-parallel cache
    ``pos`` is replicated."""
    def spec(keys, leaf):
        name = next((k for k in reversed(keys) if isinstance(k, str)), None)
        nd = _ndim(leaf)
        base = [None] * nd
        if name == "pos":
            return tuple(base)
        if nd > 0:
            base[0] = batch_axis
        if name in ("k", "v") and nd == 4:
            base[2] = kv_axis
            if kv_axis is None and attn_seq_axis is not None:
                base[1] = attn_seq_axis
        elif name in ("ckv", "krope") and nd == 3:
            base[1] = seq_axis
        elif name == "h":
            base[1] = state_axis
        elif name == "conv" and nd == 3:
            base[2] = state_axis
        return tuple(base)

    return _map_with_keys(cache, spec)


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
