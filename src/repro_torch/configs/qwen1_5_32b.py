"""qwen1.5-32b [dense] — 64L d=5120 40H (GQA kv=40 = MHA) d_ff=27392 vocab=152064.

QKV bias. [hf:Qwen/Qwen1.5-0.5B family scaled per assignment]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab_size=152_064, qkv_bias=True,
    citation="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config():
    return ModelConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=512, qkv_bias=True,
        citation="hf:Qwen/Qwen1.5-0.5B (reduced)",
    )
