"""xlstm-1.3b [ssm] — 48L d=2048 4H d_ff=0 vocab=50304.

xLSTM[7:1]: 7 mLSTM blocks per sLSTM block (projection factors 2 / 4:3).
No attention, O(1) decode state — runs long_500k natively. [arXiv:2405.04517]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50_304,
    segments=((("mlstm:-",) * 7 + ("slstm:-",), 6),),
    citation="arXiv:2405.04517",
)


def smoke_config():
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=256,
        segments=((("mlstm:-", "slstm:-"), 1),),
        citation="arXiv:2405.04517 (reduced)",
    )
