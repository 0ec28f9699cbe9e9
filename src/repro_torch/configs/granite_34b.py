"""granite-34b — 88-layer code model, MQA (kv=1) [arXiv:2405.04324].

GPTBigCode-style: multi-query attention and a non-gated (2-matrix) MLP —
that is what lands the parameter count at ~34B with d_ff = 4*d_model.
The single KV head cannot shard on a 16-way model axis (replicated KV).
"""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24_576, vocab_size=49_152, act="gelu",
)

def smoke_config():
    return shrink(CONFIG)
