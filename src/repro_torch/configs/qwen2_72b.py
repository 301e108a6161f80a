"""qwen2-72b [dense] — 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

GQA with QKV bias. [arXiv:2407.10671]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152_064, qkv_bias=True,
    rope_theta=1_000_000.0,
    citation="arXiv:2407.10671",
)


def smoke_config():
    return ModelConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512, qkv_bias=True,
        citation="arXiv:2407.10671 (reduced)",
    )
