"""Model/shape configuration system (a copy of ``repro.configs.base``).

``ModelConfig`` is a frozen (hashable) dataclass.  Each architecture
provides a module ``repro_torch/configs/<id>.py`` exposing ``CONFIG``
(full size) and ``smoke_config()`` (a reduced same-family config for CPU
tests).  The port keeps its own copy of this pure-Python data so that it
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_shared_expert: bool = False   # llama4-style always-on shared expert
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssd_chunk: int = 256

    # --- attention details ---
    rope_theta: float = 10000.0
    rope_frac: float = 1.0      # fraction of head dims rotated (chatglm 0.5, stablelm 0.25)
    window: int = 0             # sliding-window attention (mixtral: 4096); 0 = full

    # --- hybrid (zamba2) ---
    attn_every: int = 0         # apply the SHARED attention block every k-th layer

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500         # stub audio frontend: #frame embeddings

    # --- VLM (llava) ---
    n_patches: int = 0          # stub vision frontend: #patch embeddings

    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "swiglu"         # swiglu | gelu (2-mat) | relu2 (2-mat)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 so embeddings/logits shard
        cleanly on a 16-way model axis (padded logits are masked in the
        loss).  Standard Megatron-style vocab padding."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the 500k-token long-context decode cell?"""
        return self.family in ("ssm", "hybrid") or self.window > 0


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


# The four assigned LM shape cells.
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shrink(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=4 if cfg.family == "hybrid" else 2,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssd_chunk=16,
        window=16 if cfg.window else 0,
        attn_every=2 if cfg.attn_every else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_seq=24 if cfg.n_enc_layers else cfg.enc_seq,
        n_patches=8 if cfg.n_patches else 0,
    )


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    """Shape cells defined for this architecture (long_500k needs sub-quadratic)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return tuple(out)
