"""phi4-mini-3.8b [dense] — 32L d=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.

RoPE + SwiGLU + GQA, tied embeddings. [arXiv:2412.08905]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab_size=200_064, tie_embeddings=True,
    citation="arXiv:2412.08905",
)


def smoke_config():
    return ModelConfig(
        name="phi4-mini-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512, tie_embeddings=True,
        citation="arXiv:2412.08905 (reduced)",
    )
