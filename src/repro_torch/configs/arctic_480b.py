"""arctic-480b [moe] — 35L d=7168 56H (GQA kv=8) d_ff=4864 vocab=32000.

Dense-MoE hybrid: a 128-expert top-2 MoE in *parallel* with a dense FFN
residual on every layer ("moe_dense"). [hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32_000,
    segments=((("gqa:moe_dense",), 35),),
    n_experts=128, top_k=2, moe_d_ff=4864,
    citation="hf:Snowflake/snowflake-arctic-base",
)


def smoke_config():
    return ModelConfig(
        name="arctic-smoke", family="moe",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        segments=((("gqa:moe_dense",), 2),),
        n_experts=4, top_k=2, moe_d_ff=256,
        citation="hf:Snowflake/snowflake-arctic-base (reduced)",
    )
