"""stablelm-3b — dense MHA, partial RoPE (25%), LayerNorm [hf:stabilityai]."""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab_size=50_304, norm="layernorm", rope_frac=0.25,
)

def smoke_config():
    return shrink(CONFIG)
