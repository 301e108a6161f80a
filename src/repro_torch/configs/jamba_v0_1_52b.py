"""jamba-v0.1-52b [hybrid] — 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.

Mamba:attention 7:1 interleave (1 attention layer per 8-layer period),
MoE (16 experts, top-2) every other layer. [arXiv:2403.19887]
"""
from repro_torch.configs.base import ModelConfig

_PERIOD = tuple(
    f"{'gqa' if i == 4 else 'mamba'}:{'moe' if i % 2 == 1 else 'dense'}"
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65_536,
    segments=((_PERIOD, 4),),
    n_experts=16, top_k=2, moe_d_ff=14336,
    ssm_state_dim=16, ssm_conv_dim=4, ssm_expand=2,
    citation="arXiv:2403.19887",
)


def smoke_config():
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512,
        segments=((("mamba:moe", "gqa:dense"), 1),),
        n_experts=4, top_k=2, moe_d_ff=256,
        ssm_state_dim=8, ssm_conv_dim=4, ssm_expand=2,
        citation="arXiv:2403.19887 (reduced)",
    )
