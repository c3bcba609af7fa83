"""Model configuration: the port's own copy of the reference's ``ModelConfig``.

One frozen dataclass describes dense / MoE / SSM / hybrid / enc-dec / VLM
transformers; ``reduced()`` derives a smoke-test-sized config of the same
family (same layer pattern, tiny dims).  The port serves dense GQA
decoders (with qkv bias and tied embeddings), MLA decoders with dense or
routed-expert FFNs, Mamba-2 (SSD) decoders, hybrids of GQA and Mamba-2
blocks with dense or routed-expert FFNs (jamba: ``scan_period`` blocks a
layer group), an encoder-decoder (whisper: ``n_encoder_layers``
non-causal encoder blocks, a cross-attention sub-layer in every decoder
block) and a decoder with cross-attention layers on media embeddings
(llama-3.2-vision: ``cross_attn_period`` / ``cross_attn_offset``,
``n_media_tokens``).  Every field is the reference's, so configs stay
interchangeable with it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # --- identity ---------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    # --- core dims --------------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    # --- attention flavour ------------------------------------------------
    attn_kind: str = "gqa"  # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MLA (DeepSeek) ----------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ----------------------------------------------------------------
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    moe_period: int = 1  # MoE FFN every `moe_period` layers (jamba: 2)
    moe_offset: int = 0  # offset of the MoE layer within the period
    capacity_factor: float = 1.25
    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_d_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Jamba): 1 attention layer per `attn_period` ---------------
    attn_period: int = 0
    attn_offset: int = 0
    # --- VLM (Llama-3.2-Vision): 1 cross-attn layer per period --------------
    cross_attn_period: int = 0
    cross_attn_offset: int = 0
    n_media_tokens: int = 0
    # --- enc-dec (Whisper) ---------------------------------------------------
    n_encoder_layers: int = 0
    # --- numerics / training -------------------------------------------------
    dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adamw8bit | adafactor
    remat: str = "full"  # none | full
    microbatch: int = 1  # gradient-accumulation steps inside train_step
    grad_accum_dtype: str = "float32"  # accumulation buffer dtype
    # --- serving-time quantization (RSQ output) ------------------------------
    quant_bits: int = 0  # 0 = no quantization
    quant_group: int = 128
    kv_bits: int = 0  # 0 = kv cache in activation dtype; 8 = int8 codes +
    #     per-(token, head) scales; 2 = packed log codes (LogQuant-style)
    #     + per-(kv_chunk, head) scales — see kernels/flash_decode
    kv_chunk: int = 64  # tokens per 2-bit KV scale group (and the cache-
    #     length alignment unit for any quantized cache)

    # ------------------------------------------------------------------ dims
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def v_dim(self) -> int:
        return self.v_head_dim if self.attn_kind == "mla" else self.head_dim

    @property
    def qk_dim(self) -> int:
        if self.attn_kind == "mla":
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def uses_moe(self) -> bool:
        return self.n_routed_experts > 0

    # --------------------------------------------------------- layer pattern
    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind per decoder layer: 'attn' | 'mamba' | 'cross'."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "hybrid":
                k = "attn" if i % self.attn_period == self.attn_offset else "mamba"
            elif self.family == "ssm":
                k = "mamba"
            elif self.family == "vlm" and (
                i % self.cross_attn_period == self.cross_attn_offset
            ):
                k = "cross"
            else:
                k = "attn"
            kinds.append(k)
        return tuple(kinds)

    def ffn_kinds(self) -> Tuple[str, ...]:
        """FFN kind per decoder layer: 'dense' | 'moe' | 'none'."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                kinds.append("none")  # Mamba-2 backbone has no separate FFN
            elif self.uses_moe and i >= self.first_dense_layers and (
                i % self.moe_period == self.moe_offset
            ):
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)

    @property
    def scan_period(self) -> int:
        """Length of the repeating layer pattern (scan group size)."""
        p = 1
        if self.family == "hybrid":
            p = math.lcm(p, self.attn_period, self.moe_period or 1)
        if self.family == "vlm":
            p = math.lcm(p, self.cross_attn_period)
        if self.uses_moe and self.moe_period > 1:
            p = math.lcm(p, self.moe_period)
        return p

    # ------------------------------------------------------------ param math
    def n_embedding_params(self) -> int:
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n *= 2
        return n

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_kind == "mla":
            n = 0
            q_in = self.q_lora_rank if self.q_lora_rank else d
            if self.q_lora_rank:
                n += d * self.q_lora_rank
            n += q_in * self.n_heads * self.qk_dim
            n += d * (self.kv_lora_rank + self.qk_rope_dim)
            n += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
            n += self.n_heads * self.v_head_dim * d
            return n
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim
        return d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d

    def _dense_ffn_params(self) -> int:
        return 3 * self.d_model * self.d_ff

    def _moe_ffn_params(self, active_only: bool = False) -> int:
        e = (self.moe_top_k if active_only else self.n_routed_experts)
        n = e * 3 * self.d_model * self.moe_d_ff
        n += self.n_shared_experts * 3 * self.d_model * self.moe_d_ff
        n += self.d_model * self.n_routed_experts  # router
        return n

    def _mamba_params(self) -> int:
        d, di, st = self.d_model, self.d_inner, self.ssm_d_state
        nh = self.ssm_n_heads
        n = d * (2 * di + 2 * st + nh)  # in_proj -> (x, z, B, C, dt)
        n += self.ssm_conv_width * (di + 2 * st)  # depthwise conv
        n += nh * 2  # A_log, D
        n += di * d  # out_proj
        return n

    def n_params(self, active_only: bool = False) -> int:
        """Total (or active, for MoE) parameter count."""
        total = self.n_embedding_params()
        for kind, ffn in zip(self.layer_kinds(), self.ffn_kinds()):
            if kind == "mamba":
                total += self._mamba_params()
            elif kind == "cross":
                total += self._attn_params()
            else:
                total += self._attn_params()
            if ffn == "dense":
                total += self._dense_ffn_params()
            elif ffn == "moe":
                total += self._moe_ffn_params(active_only=active_only)
        if self.family == "encdec":
            for _ in range(self.n_encoder_layers):
                total += self._attn_params() + self._dense_ffn_params()
            # decoder cross-attention per layer
            total += self.n_layers * self._attn_params()
        return total

    # ----------------------------------------------------------------- smoke
    def reduced(self) -> "ModelConfig":
        """Same family/pattern, tiny dims — runnable on 1 CPU device."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=max(2, self.scan_period),
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab_size=512,
            d_head=16,
        )
        if self.attn_kind == "mla":
            kw.update(
                q_lora_rank=32 if self.q_lora_rank else 0,
                kv_lora_rank=32,
                qk_nope_dim=16,
                qk_rope_dim=8,
                v_head_dim=16,
                d_head=0,
            )
        if self.uses_moe:
            kw.update(
                n_routed_experts=4,
                n_shared_experts=min(self.n_shared_experts, 1),
                moe_top_k=2,
                moe_d_ff=64,
                first_dense_layers=min(self.first_dense_layers, 1),
            )
            kw["n_layers"] = max(kw["n_layers"], self.first_dense_layers and 2 or 2)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_d_state=16, ssm_head_dim=16, ssm_chunk=32)
        if self.family == "hybrid":
            kw.update(attn_period=self.attn_period and 4, attn_offset=1,
                      moe_period=2, moe_offset=1, n_layers=4)
        if self.family == "vlm":
            kw.update(cross_attn_period=2, cross_attn_offset=1,
                      n_media_tokens=8, n_layers=4)
        if self.family == "encdec":
            kw.update(n_encoder_layers=2)
        return dataclasses.replace(self, **kw)
