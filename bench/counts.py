"""The yardstick's arithmetic, frozen here so that no change to the
program moves it: parameter and FLOP counts of a configuration, the
operations and bytes of the kernels whose roofline share the benchmark
reads, and the bytes a decode step must move.

``param_counts`` and ``model_flops`` are copies of the port's
``launch/analytic.py`` (6·N·D for a training step and 2·N·D for prefill
and decode, N the active parameters, plus the attention term;
recomputation not counted), over sizes worked out from the configuration
file's ``model`` dict instead of a traced tree. A kernel's bytes count
each input read once and each output written once.
"""
from __future__ import annotations

import math

BLOCK, ROWS = 256, 8            # the flat wire layout's block and tile rows


def layer_kinds(arch):
    return [kind for pattern, repeats in arch["segments"]
            for _ in range(repeats) for kind in pattern]


def layer_leaf_shapes(kind, arch):
    """{leaf: shape} of one layer of ``kind`` in the port's tree."""
    d, H, KV, hd = (arch["d_model"], arch["n_heads"], arch["n_kv_heads"],
                    arch["head_dim"])
    mixer, ffn = kind.split(":")
    out = {"norm1/g": (d,)}
    if mixer == "gqa":
        out.update({"mixer/wq": (d, H, hd), "mixer/wk": (d, KV, hd),
                    "mixer/wv": (d, KV, hd), "mixer/wo": (H, hd, d)})
        if arch.get("qkv_bias"):
            out.update({"mixer/bq": (H, hd), "mixer/bk": (KV, hd),
                        "mixer/bv": (KV, hd)})
    elif mixer == "mamba":
        di = arch["ssm_expand"] * d
        st, K = arch["ssm_state_dim"], arch["ssm_conv_dim"]
        r = arch["ssm_dt_rank"]
        out.update({"mixer/A_log": (di, st), "mixer/D": (di,),
                    "mixer/conv_b": (di,), "mixer/conv_w": (K, di),
                    "mixer/dt_proj/b": (di,), "mixer/dt_proj/w": (r, di),
                    "mixer/in_proj": (d, 2 * di), "mixer/out_proj": (di, d),
                    "mixer/x_proj": (di, r + 2 * st)})
    else:
        raise ValueError(f"no count for mixer {mixer!r}")
    if ffn != "-":
        out["norm2/g"] = (d,)
        if ffn == "dense":
            f = arch["d_ff"]
            out.update({"ffn/wi": (d, f), "ffn/wg": (d, f), "ffn/wo": (f, d)})
        elif ffn == "moe":
            E, f = arch["n_experts"], arch["moe_d_ff"]
            out.update({"ffn/router": (d, E), "ffn/wi": (E, d, f),
                        "ffn/wg": (E, d, f), "ffn/wo": (E, f, d)})
        else:
            raise ValueError(f"no count for ffn {ffn!r}")
    return out


def leaf_sizes(arch):
    """Elements of every leaf of the tree, a stacked leaf (``repeats``
    layers of one pattern position) counted as one."""
    d, V = arch["d_model"], arch["vocab_size"]
    sizes = [V * d, d] + ([] if arch.get("tie_embeddings") else [d * V])
    for pattern, repeats in arch["segments"]:
        for kind in pattern:
            sizes += [repeats * math.prod(s) for s in
                      layer_leaf_shapes(kind, arch).values()]
    return sizes


def param_counts(arch):
    """(total, active): the routed experts beyond ``top_k`` are
    inactive."""
    total = sum(leaf_sizes(arch))
    inactive = 0
    if arch.get("n_experts"):
        n_moe = sum(k.endswith((":moe", ":moe_dense"))
                    for k in layer_kinds(arch))
        inactive = n_moe * (arch["n_experts"] - arch["top_k"]) * \
            3 * arch["d_model"] * arch["moe_d_ff"]
    return total, total - inactive


def model_flops(arch, batch, seq, kind):
    """FLOPs of one step over ``batch`` x ``seq`` tokens: ``kind`` is
    "train" (forward and backward), "prefill" or "decode" (one token a
    sequence against ``seq`` of context)."""
    _, active = param_counts(arch)
    n_attn = sum(k.split(":")[0] in ("gqa", "mla") for k in layer_kinds(arch))
    if kind == "train":
        tokens, base, mult = batch * seq, 6 * active * batch * seq, 3
    elif kind == "prefill":
        tokens, base, mult = batch * seq, 2 * active * batch * seq, 1
    else:
        tokens, base, mult = batch, 2 * active * batch, 1
    window = arch.get("window", 0)
    s_kv = min(window, seq) if window else seq
    if kind == "decode":
        ctx = s_kv
    else:
        ctx = s_kv / 2 if not window else min(s_kv, seq / 2)
    hd = arch["head_dim"]
    attn = 2 * tokens * ctx * arch["n_heads"] * (hd + hd) * n_attn * mult
    return base + attn


# ---------------------------------------------------------------------------
# kernels: (operations, bytes) of one launch
# ---------------------------------------------------------------------------
def wire_n_pad(arch):
    """Columns of the flat wire buffer: every leaf block-aligned, the end
    rounded up to whole ROWS x BLOCK tiles."""
    n = sum(-(-s // BLOCK) * BLOCK for s in leaf_sizes(arch))
    tile = ROWS * BLOCK
    return -(-n // tile) * tile


def k3(arch, participants):
    """The fused quantize-average-dequantize pass over (K, N_pad) f32: reads
    K rows, writes the (N_pad,) mean; per element a scale's max, a
    division, a rounding, a product and a sum."""
    n = wire_n_pad(arch)
    return 5 * participants * n, 4 * (participants + 1) * n


def k5(batch, seq, heads, kv_heads, head_dim):
    """Causal flash attention: q·k and p·v over the S(S+1)/2 pairs a row
    and head; q, k, v read, o written (f32)."""
    pairs = seq * (seq + 1) // 2
    ops = 4 * batch * heads * pairs * head_dim
    nbytes = 4 * batch * seq * head_dim * (2 * heads + 2 * kv_heads)
    return ops, nbytes


def k6(batch, seq, d_inner, d_state):
    """The selective scan from a zero state: per (row, step, channel,
    state) the decay's product and exp, dt·B·x, the update and the
    read-out; x, dt, B, C, A, D read, y and the last state written."""
    ops = 8 * batch * seq * d_inner * d_state + 2 * batch * seq * d_inner
    nbytes = 4 * (3 * batch * seq * d_inner + 2 * batch * seq * d_state
                  + d_inner * d_state + d_inner + batch * d_inner * d_state)
    return ops, nbytes


def decode_step_bytes(arch, batch, prompt, new):
    """Bytes one decode step must move, averaged over a call's prompt and
    decode steps: every weight once (of the input table only the batch's
    rows), each attention layer's cached keys and values up to the step's
    position read and the new ones written."""
    d, V = arch["d_model"], arch["vocab_size"]
    total, _ = param_counts(arch)
    weights = 4 * (total - V * d + batch * d)
    n_attn = sum(k.split(":")[0] == "gqa" for k in layer_kinds(arch))
    row = 2 * n_attn * batch * arch["n_kv_heads"] * arch["head_dim"] * 4
    mean_ctx = (prompt + new + 1) / 2
    return weights + row * (mean_ctx + 1)
