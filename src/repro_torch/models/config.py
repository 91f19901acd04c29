"""Architecture configuration schema (the port's own copy).

One frozen dataclass describes every architecture of the JAX package
(dense / MoE / SSM / hybrid / VLM / audio), field for field, so a config
compares with the JAX package's by ``dataclasses.asdict``.  The port's
language model (transformer.py) runs every kind.  configs/<id>.py
instantiate it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# Layer kinds usable in ``block_pattern`` (cycled over the depth).
ATTN = "attn"        # global causal attention (GQA/MQA/MHA or MLA)
LOCAL = "local"      # sliding-window causal attention (cfg.window)
MAMBA = "mamba"      # mamba-1 selective SSM block (attention-free)
RGLRU = "rglru"      # Griffin RG-LRU gated linear recurrence block


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False               # chameleon-style qk layernorm
    attn_softcap: float = 0.0           # grok-style tanh logit cap
    rope_theta: float = 10000.0
    # --- mlp ---
    d_ff: int = 0
    activation: str = "silu"            # silu (SwiGLU) | gelu (GeGLU)
    # --- layer pattern ---
    block_pattern: Tuple[str, ...] = (ATTN,)
    window: int = 0                     # width for LOCAL layers
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    topk: int = 0
    moe_d_ff: int = 0                   # per-expert hidden width
    first_dense_layers: int = 0         # deepseek: leading dense layer(s)
    capacity_factor: float = 1.25
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorbed: bool = False   # absorbed-matrix MLA decode (§Perf)
    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    dt_rank: int = 0
    # --- hybrid (RG-LRU) ---
    lru_width: int = 0
    # --- audio ---
    num_codebooks: int = 1
    # --- embeddings / head ---
    tie_embeddings: bool = True
    emb_scale: bool = False             # gemma: scale embeddings by sqrt(d)
    # --- long-context serving variant ---
    sliding_variant_window: int = 0     # >0: long_500k uses this window
    # --- FL integration ---
    fl_mode: str = "fedavg_replica"     # fedavg_replica (A) | trust_fsdp (B)
    # --- the JAX package's sharding and layer-loop options (kept so a
    # config converts field for field; the port unrolls its layers) ---
    shard_scheme: str = "tp"
    unroll_layers: bool = False
    scan_indexed: bool = False

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.arch_type == "ssm" and not self.dt_rank:
            object.__setattr__(self, "dt_rank", math.ceil(self.d_model / 16))
        if self.lru_width == 0 and RGLRU in self.block_pattern:
            object.__setattr__(self, "lru_width", self.d_model)

    # ------------------------------------------------------------------ #
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind for the full depth, cycling block_pattern."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a multiple of 128, as in the JAX
        package; pad logits are masked to -1e9 in unembed."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def d_inner(self) -> int:           # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def attends(self) -> bool:
        return any(k in (ATTN, LOCAL) for k in self.layer_kinds())

    @property
    def subquadratic(self) -> bool:
        """True if no *global* attention layer exists (long_500k-capable
        natively) — LOCAL/MAMBA/RGLRU only."""
        return all(k != ATTN for k in self.layer_kinds())

    def long_context_variant(self) -> "ArchConfig":
        """Serving variant used for long_500k: swap global attention for
        sliding-window attention when the arch declares a window."""
        if self.subquadratic:
            return self
        if self.sliding_variant_window <= 0:
            raise ValueError(
                f"{self.name} is full-attention with no sliding-window "
                f"variant; long_500k is inapplicable")
        pat = tuple(LOCAL if k == ATTN else k for k in self.block_pattern)
        return dataclasses.replace(
            self, block_pattern=pat, window=self.sliding_variant_window)

    # -- parameter count (analytic, for rooflines: MODEL_FLOPS = 6 N D) -- #
    def param_count(self, active_only: bool = False) -> int:
        n = self.vocab_size * self.d_model * self.num_codebooks  # embed
        if not self.tie_embeddings:
            n += self.d_model * self.vocab_size * self.num_codebooks
        n += self.d_model  # final norm
        for kind in self.layer_kinds():
            n += self._layer_params(kind, active_only)
        return n

    def _layer_params(self, kind: str, active_only: bool) -> int:
        d = self.d_model
        n = 2 * d  # two rmsnorms (attn/mlp) or one+block norm
        if kind in (ATTN, LOCAL):
            if self.use_mla:
                rank_q = self.q_lora_rank or d
                qk = self.qk_nope_dim + self.qk_rope_dim
                if self.q_lora_rank:
                    n += d * self.q_lora_rank + self.q_lora_rank * self.num_heads * qk
                else:
                    n += d * self.num_heads * qk
                n += d * (self.kv_lora_rank + self.qk_rope_dim)
                n += self.kv_lora_rank * self.num_heads * (self.qk_nope_dim + self.v_head_dim)
                n += self.num_heads * self.v_head_dim * d
            else:
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
            n += self._mlp_params(active_only)
        elif kind == MAMBA:
            di, N, r = self.d_inner, self.ssm_state, self.dt_rank
            n += d * 2 * di + di * self.ssm_conv + di * (r + 2 * N)
            n += r * di + di * N + di + di * d
        elif kind == RGLRU:
            w = self.lru_width
            n += 2 * d * w + w * self.ssm_conv + 2 * w * w + 3 * w + w * d
            n += self._mlp_params(active_only)
        return n

    def _mlp_params(self, active_only: bool) -> int:
        d = self.d_model
        if self.num_experts:
            e_all = 3 * d * self.moe_d_ff
            n = d * self.num_experts                       # router
            n += self.num_shared_experts * e_all
            k = self.topk if active_only else self.num_experts
            n += k * e_all
            return n
        return 3 * d * self.d_ff
