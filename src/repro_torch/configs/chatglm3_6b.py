"""chatglm3-6b — dense, GQA kv=2, half-rotary ("2d") RoPE [arXiv:2406.12793]."""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13_696, vocab_size=65_024, rope_frac=0.5,
)

def smoke_config():
    return shrink(CONFIG)
