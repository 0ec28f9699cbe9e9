"""zamba2-7b — hybrid: Mamba2 backbone + shared attention block [arXiv:2411.15242].

81 Mamba2 layers (d_inner = 7168, 112 SSD heads, state 64) with one SHARED
attention+MLP block invoked every 9th layer (zamba2's parameter-shared
global-attention design; the per-invocation LoRA deltas are omitted — see
DESIGN.md assumptions table).
"""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14_336, vocab_size=32_000, ssm_state=64, ssm_expand=2,
    ssm_head_dim=64, attn_every=9, tie_embeddings=True,
)

def smoke_config():
    return shrink(CONFIG)
