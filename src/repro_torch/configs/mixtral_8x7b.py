"""mixtral-8x7b — 8 experts top-2, sliding-window attention [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14_336, vocab_size=32_000, n_experts=8, top_k=2, window=4096,
)

def smoke_config():
    return shrink(CONFIG)
