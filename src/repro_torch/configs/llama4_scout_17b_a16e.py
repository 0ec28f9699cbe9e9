"""llama4-scout-17b-16e — MoE, 16 experts top-1 + shared expert [hf:meta-llama]."""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202_048, n_experts=16, top_k=1,
    moe_shared_expert=True,
)

def smoke_config():
    return shrink(CONFIG)
