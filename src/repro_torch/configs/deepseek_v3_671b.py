"""deepseek-v3-671b [moe] — 61L d=7168 128H d_ff(expert)=2048 vocab=129280.

MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v_head 128); first 3
layers dense (d_ff 18432 per the paper), remaining 58 layers MoE with
1 shared + 256 routed experts, top-8; MTP depth 1. [arXiv:2412.19437]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab_size=129_280,
    segments=((("mla:dense",), 3), (("mla:moe",), 58)),
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, head_dim=192,
    n_experts=256, top_k=8, moe_d_ff=2048, n_shared_experts=1,
    mtp_depth=1,
    citation="arXiv:2412.19437",
)


def smoke_config():
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
        d_ff=512, vocab_size=512,
        segments=((("mla:dense",), 1), (("mla:moe",), 1)),
        q_lora_rank=64, kv_lora_rank=32,
        qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32, head_dim=48,
        n_experts=4, top_k=2, moe_d_ff=128, n_shared_experts=1,
        mtp_depth=1,
        citation="arXiv:2412.19437 (reduced)",
    )
