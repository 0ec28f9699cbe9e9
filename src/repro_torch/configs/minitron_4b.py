"""minitron-4b — width/depth-pruned nemotron [arXiv:2407.14679].

Nemotron recipe: LayerNorm, squared-ReLU (non-gated) MLP, partial RoPE,
huge 256k vocab (the interesting sharding stressor of this arch).
"""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256_000, norm="layernorm", act="relu2",
    rope_frac=0.5,
)

def smoke_config():
    return shrink(CONFIG)
