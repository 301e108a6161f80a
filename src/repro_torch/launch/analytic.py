"""Analytic FLOP and parameter account, ported from
``repro/launch/analytic.py``.

Pure shape arithmetic over ``launch/steps.params_shapes`` (the params tree
on the ``meta`` device: nothing allocated), so it runs at every
architecture's full size on any host.

* ``param_counts``: exact (total, active) parameter counts; the routed
  experts beyond ``top_k`` count as inactive.
* ``model_flops``: 6·N_active·D for a training step (2·N_active·D for
  prefill and decode) plus the attention term, with MLA's absorbed head
  sizes: the useful-compute numerator of an achieved-FLOP/s share.
* ``scan_corrections`` (with ``CHUNK_Q`` / ``CHUNK_KV``) corrects XLA's
  ``cost_analysis()``, which counts a ``lax.scan`` body once: the FLOPs
  of the chunked attention and the recurrences' inner scans that a
  once-counted body misses. It has no torch consumer yet (a device-side
  FLOP account of the port counts each launch) and is kept for parity
  with the reference, whose dry run reads it.
"""
from __future__ import annotations

from repro_torch.launch import steps as steps_mod
from repro_torch.tree import leaves

CHUNK_Q = 1024
CHUNK_KV = 1024


def param_counts(cfg):
    """(total, active) parameter counts, exact from the meta tree."""
    total = sum(t.numel() for t in leaves(steps_mod.params_shapes(cfg)))
    # inactive = routed-expert params beyond top_k, per MoE layer
    inactive = 0
    if cfg.n_experts:
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        n_moe_layers = sum(1 for k in cfg.layer_kinds()
                           if k.endswith((":moe", ":moe_dense")))
        inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total, total - inactive


def _attn_layers(cfg):
    kinds = [k.split(":")[0] for k in cfg.layer_kinds()]
    return {m: kinds.count(m)
            for m in ("gqa", "mla", "mamba", "mlstm", "slstm")}


def _attn_head_dims(cfg, n):
    """(q·k head size, v head size); MLA attends in its absorbed form."""
    if n["mla"]:
        return cfg.kv_lora_rank + cfg.qk_rope_dim, cfg.kv_lora_rank
    return cfg.head_dim, cfg.v_head_dim or cfg.head_dim


def model_flops(cfg, shape, kind):
    """6·N_active·D (+ the attention quadratic term); ``kind`` is
    ``"train"``, ``"prefill"`` or ``"decode"`` (one token a sequence)."""
    _, active = param_counts(cfg)
    n = _attn_layers(cfg)
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6 * active * tokens
        mult = 3  # fwd+bwd
    elif kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        base = 2 * active * tokens
        mult = 1
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        base = 2 * active * tokens
        mult = 1
    S_kv = (min(cfg.window, shape.seq_len) if cfg.window else shape.seq_len)
    if kind == "decode":
        attn_ctx = S_kv
    else:
        attn_ctx = S_kv / 2 if not cfg.window else min(S_kv, shape.seq_len / 2)
    hd_qk, hd_v = _attn_head_dims(cfg, n)
    attn = 2 * tokens * attn_ctx * cfg.n_heads * (hd_qk + hd_v) * \
        (n["gqa"] + n["mla"]) * mult
    return base + attn


def scan_corrections(cfg, shape, kind):
    """FLOPs a once-counted inner scan misses, per compiled module (see the
    module docstring)."""
    if kind == "decode":
        return 0.0                                   # no inner scans at decode
    T = shape.global_batch * shape.seq_len
    S = shape.seq_len
    mult = 3 if kind == "train" else 1
    n = _attn_layers(cfg)
    missed = 0.0
    # chunked attention: trips = nq*nk (both scans), counted once
    S_kv = min(cfg.window, S) if cfg.window else S
    nq = max(S // CHUNK_Q, 1)
    nk = max(S_kv // CHUNK_KV, 1)
    trips = nq * nk
    if trips > 1 and (n["gqa"] or n["mla"]):
        hd_qk, hd_v = _attn_head_dims(cfg, n)
        ctx = S_kv / 2 if not cfg.window else min(S_kv, S / 2)
        attn = 2 * T * ctx * cfg.n_heads * (hd_qk + hd_v) * \
            (n["gqa"] + n["mla"]) * mult
        missed += attn * (trips - 1) / trips
    # mamba selective scan: ~10 flops per (t, di, st) cell, trips = S
    if n["mamba"]:
        di, st = cfg.d_inner_ssm, cfg.ssm_state_dim
        scan_f = 10 * T * di * st * n["mamba"] * mult
        missed += scan_f * (S - 1) / S
    # mLSTM: rank-1 update + readout ≈ 6·hd² per (t, head), trips = S
    if n["mlstm"]:
        di = int(cfg.xlstm_proj_factor * cfg.d_model)
        hd = di // cfg.n_heads
        f = 6 * T * cfg.n_heads * hd * hd * n["mlstm"] * mult
        missed += f * (S - 1) / S
    # sLSTM: recurrent matmul hd×4hd per (t, head), trips = S
    if n["slstm"]:
        hd = cfg.d_model // cfg.n_heads
        f = 2 * T * cfg.n_heads * hd * 4 * hd * n["slstm"] * mult
        missed += f * (S - 1) / S
    return missed
