"""Model/config dataclasses for the repro framework.

Every assigned architecture gets one file in this package exporting
``CONFIG`` (the exact published shape, citation in the docstring) and
``smoke_config()`` (a reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# A layer pattern entry is "<mixer>:<ffn>" where
#   mixer ∈ {gqa, mla, mamba, slstm, mlstm}
#   ffn   ∈ {dense, moe, moe_dense, -}   (moe_dense = MoE in parallel with a
#                                         dense FFN residual, as in Arctic)
Segment = tuple[tuple[str, ...], int]  # (pattern, repeats)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    segments: tuple[Segment, ...] = ()   # derived: default all gqa:dense
    head_dim: int = 0                    # 0 => d_model // n_heads
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # Attention variants
    window: int = 0                  # 0 => full causal; >0 => sliding window
    # MLA (DeepSeek-V3) geometry
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba)
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 => ceil(d_model / 16)

    # xLSTM
    xlstm_proj_factor: float = 2.0   # mLSTM up-projection factor
    slstm_proj_factor: float = 1.3334

    # Multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0

    # Modality frontend stub
    input_mode: str = "tokens"       # tokens | embeddings | tokens+prefix
    prefix_len: int = 256            # VLM: #patch embeddings prepended

    citation: str = ""

    def __post_init__(self):
        if not self.segments:
            object.__setattr__(self, "segments", ((("gqa:dense",), self.n_layers),))
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        total = sum(len(p) * r for p, r in self.segments)
        assert total == self.n_layers, (self.name, total, self.n_layers)

    # ---- derived helpers -------------------------------------------------
    @property
    def d_inner_ssm(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def layer_kinds(self):
        """Flat list of n_layers '<mixer>:<ffn>' strings, in order."""
        out = []
        for pattern, repeats in self.segments:
            for _ in range(repeats):
                out.extend(pattern)
        return out

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    seq_len: int = 128
    lr: float = 0.01                 # paper: eta^i = 0.01 (constant across rounds)
    optimizer: str = "sgd"           # sgd | momentum | adamw (paper: SGD)
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    param_dtype: str = "bfloat16"
    # read by nothing in either package: the step builders and loss_fn
    # take their own remat= (default True, per-layer recomputation)
    remat: bool = True
    seed: int = 0


@dataclass(frozen=True)
class CoLearnConfig:
    """The paper's Algorithm 1 knobs (Eqs. 3, 4).

    ``schedule``/``epochs_rule`` are the legacy string spellings of the
    ``api.LRSchedule``/``api.SyncPolicy`` strategy objects — a ``CoLearner``
    built without explicit ``schedule=``/``sync_policy=`` arguments
    resolves them through ``api.SCHEDULES``/``api.SYNC_POLICIES``. (The
    old ``compress`` field is gone: wire codecs are objects/registry names
    passed to ``CoLearner(codec=...)`` — see ROADMAP.md §Round strategy
    API migration table.)
    """
    n_participants: int = 5          # paper: 5 data centers
    T0: int = 5                      # initial local epochs (paper: 5 or 20)
    eta0: float = 0.01               # paper: constant shared eta^i
    decay_rate: float = 0.25         # paper: r = 1/4
    epsilon: float = 0.01            # Eq.4 relative-change threshold
    schedule: str = "clr"            # clr | elr  (cyclical vs exponential)
    epochs_rule: str = "ile"         # ile | fle  (increasing vs fixed)
    max_rounds: int = 10


# --- input shapes assigned to this paper (public pool) ---------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
