"""internvl2-76b [vlm] — 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternViT-6B vision encoder + projector are the modality-frontend stub
(carve-out): ``input_specs()`` supplies precomputed patch embeddings of
shape (B, prefix_len, d_model) prepended to the text tokens. The LLM
backbone implemented here is the Llama-3-70B-shaped decoder InternVL2-76B
uses. [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128_256,
    input_mode="tokens+prefix", prefix_len=256,
    rope_theta=500_000.0,
    citation="arXiv:2404.16821",
)


def smoke_config():
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        input_mode="tokens+prefix", prefix_len=16,
        citation="arXiv:2404.16821 (reduced)",
    )
