"""musicgen-large [audio] — 48L d=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only transformer over EnCodec tokens. The EnCodec conv codec itself
is the modality-frontend stub (carve-out): ``input_specs()`` supplies the
precomputed code tokens. [arXiv:2306.05284]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    citation="arXiv:2306.05284",
)


def smoke_config():
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=256,
        citation="arXiv:2306.05284 (reduced)",
    )
