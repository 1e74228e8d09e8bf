"""Model configuration of the port.

A copy of the reference's ``ModelConfig`` dataclass, so that a
configuration means the same thing on both sides.  The port keeps its own
registry: this slice registers ``qwen1.5-4b`` only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio

    num_layers: int = 0
    d_model: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # ---- attention ----
    attention: str = "gqa"  # gqa | mla | none
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # glm4 uses partial rotary (0.5)
    pos_emb: str = "rope"  # rope | learned | none

    # ---- MLA (DeepSeek-V2) ----
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # ---- MoE ----
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0          # leading dense layers (deepseek-v2)
    moe_layer_period: int = 1       # a layer l is MoE iff l % period == offset
    moe_layer_offset: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # ---- SSM (Mamba2 / SSD) ----
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # ---- hybrid interleave (Jamba) ----
    block_period: int = 1           # sublayers per scanned super-block
    attn_positions: Tuple[int, ...] = ()  # positions within period using attention

    # ---- encoder-decoder ----
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0

    # ---- modality frontend (stub: input_specs provides embeddings) ----
    frontend: str = "none"          # none | vision | audio
    frontend_tokens: int = 0        # prepended embedding tokens (vision)
    frontend_dim: int = 0           # raw embedding dim before projection

    # ---- misc ----
    act: str = "silu"               # silu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_position: int = 1 << 20

    # ---- implementation switches (perf levers, not architecture) ----
    moe_impl: str = "auto"          # auto | dense | ep (shard_map all-to-all)
    attn_impl: str = "blockwise"    # blockwise | naive
    remat: str = "block"            # none | block | full
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so the TP-sharded unembed
        divides any mesh axis (standard Megatron/MaxText practice).  Pad
        logits are masked to -inf in ``layers.unembed``."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_attention_free(self) -> bool:
        return self.attention == "none" and not self.attn_positions

    @property
    def is_sub_quadratic(self) -> bool:
        """True if long-context decode (500k) is feasible: SSM or hybrid."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def q_dim(self) -> int:
        if self.attention == "mla":
            return self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.num_heads * self.head_dim

    @property
    def kv_cache_bytes_per_token_per_layer(self) -> int:
        """bf16 KV bytes for one token in one *attention* layer."""
        if self.attention == "mla":
            return 2 * (self.kv_lora_rank + self.qk_rope_head_dim)
        if self.attention == "gqa":
            return 2 * 2 * self.num_kv_heads * self.head_dim
        return 0

    def attn_layer_ids(self) -> Tuple[int, ...]:
        """Absolute indices of attention layers (for hybrid archs)."""
        if self.attention == "none" and not self.attn_positions:
            return ()
        if not self.attn_positions:  # all layers attend
            return tuple(range(self.num_layers))
        out = []
        for l in range(self.num_layers):
            if l % self.block_period in self.attn_positions:
                out.append(l)
        return tuple(out)

    def moe_layer_ids(self) -> Tuple[int, ...]:
        if not self.has_moe:
            return ()
        out = []
        for l in range(self.num_layers):
            if l < self.first_k_dense:
                continue
            if l % self.moe_layer_period == self.moe_layer_offset:
                out.append(l)
        return tuple(out)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6·N·D) ----
    def param_count(self, active_only: bool = False) -> int:
        n = 0
        d = self.d_model
        n += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        if self.frontend_dim:
            n += self.frontend_dim * d
        for l in range(self.num_layers):
            n += self._layer_params(l, active_only)
        if self.is_encoder_decoder:
            for l in range(self.num_encoder_layers):
                n += self._enc_layer_params()
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attention == "mla":
            n = 0
            if self.q_lora_rank:
                n += d * self.q_lora_rank + self.q_lora_rank * self.q_dim
            else:
                n += d * self.q_dim
            n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
            n += self.kv_lora_rank * self.num_heads * (
                self.qk_nope_head_dim + self.v_head_dim)
            n += self.num_heads * self.v_head_dim * d
            return n
        h, kv, hd = self.num_heads, self.num_kv_heads, self.head_dim
        return d * hd * (h + 2 * kv) + h * hd * d

    def _mlp_params(self, ff: int) -> int:
        return 3 * self.d_model * ff  # gated (gate, up, down)

    def _ssm_params(self) -> int:
        d, di = self.d_model, self.ssm_d_inner
        nh, ds = self.ssm_heads, self.ssm_state
        n = d * (2 * di + 2 * ds + nh)        # proj -> x, z, B, C, dt (G=1)
        n += self.ssm_conv_width * (di + 2 * ds)  # conv over x,B,C
        n += nh + nh + nh + di                # A_log, D, dt_bias, gate norm
        n += di * d                           # out_proj
        return n

    def _layer_params(self, l: int, active_only: bool) -> int:
        n = 0
        is_attn = l in self.attn_layer_ids() if (
            self.attn_positions or self.attention == "none") else True
        if self.attention != "none" and is_attn:
            n += self._attn_params()
        elif self.ssm_state:
            n += self._ssm_params()
        if self.has_moe and l in self.moe_layer_ids():
            e = self.moe_top_k if active_only else self.num_experts
            n += e * self._mlp_params(self.moe_d_ff) // 1
            n += self.num_shared_experts * self._mlp_params(self.moe_d_ff)
            n += self.d_model * self.num_experts  # router
        elif self.d_ff:
            n += self._mlp_params(self.d_ff)
        n += 2 * self.d_model  # norms
        return n

    def _enc_layer_params(self) -> int:
        return self._attn_params() + 2 * self.d_model * self.d_ff + 2 * self.d_model


# ----------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    import repro_torch.configs.qwen1_5_4b  # noqa: F401  (populates registry)
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs():
    import repro_torch.configs.qwen1_5_4b  # noqa: F401
    return sorted(_REGISTRY)


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    small = dict(
        num_layers=min(cfg.num_layers, 4) if not cfg.block_period > 1
        else cfg.block_period,
        d_model=128,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32 if cfg.num_heads else cfg.head_dim,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        q_lora_rank=0,
        qk_nope_head_dim=32 if cfg.attention == "mla" else cfg.qk_nope_head_dim,
        qk_rope_head_dim=16 if cfg.attention == "mla" else cfg.qk_rope_head_dim,
        v_head_dim=32 if cfg.attention == "mla" else cfg.v_head_dim,
        num_experts=min(cfg.num_experts, 8),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=32 if cfg.ssm_state else cfg.ssm_chunk,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        frontend_tokens=min(cfg.frontend_tokens, 8),
        frontend_dim=64 if cfg.frontend_dim else 0,
        max_position=4096,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
