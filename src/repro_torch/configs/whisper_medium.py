"""whisper-medium — encoder-decoder audio backbone [arXiv:2212.04356].

The conv/mel frontend is a STUB: input_specs() provides precomputed frame
embeddings (batch, enc_seq, d_model).  Learned positional embeddings,
LayerNorm, GELU MLPs, MHA (16 heads == 16 kv heads), tied embeddings.
"""
from repro_torch.configs.base import ModelConfig, shrink

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=51_865, enc_seq=1500,
    norm="layernorm", act="gelu", rope_frac=0.0, tie_embeddings=True,
)

def smoke_config():
    return shrink(CONFIG)
