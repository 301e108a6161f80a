"""internlm2-1.8b [dense] — 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.

[arXiv:2403.17297]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92_544,
    citation="arXiv:2403.17297",
)


def smoke_config():
    return ModelConfig(
        name="internlm2-smoke", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=4,
        d_ff=512, vocab_size=512,
        citation="arXiv:2403.17297 (reduced)",
    )
