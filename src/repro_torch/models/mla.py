"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437), ported
from ``repro/models/mla.py``.

The *absorbed* form throughout, as in the reference: queries are projected
into the KV latent space (``q_eff = q_nope @ W_uk``), so attention is
MQA-like over one shared latent "KV head" of width ``kv_lora_rank`` plus
the decoupled RoPE key of width ``qk_rope_dim``: q and k are
``kv_lora + rope`` wide (576 at full width), v is the latent ``c_kv``
(512), and the softmax scale is ``(nope + rope)^-1/2``. The training /
prefill forward runs through ``attention.chunked_attention`` with
``n_kv_heads=1`` whatever ``impl`` asks, as the reference ignores it:
MLA never reaches the flash-attention kernel.

Decode: the cache of one layer is ``{"c_kv", "k_rope"}`` of shape
(B, S, kv_lora) and (B, S, rope), the paper's KV-cache compression (576
floats a token a layer where the 128 heads' keys and values of this width
would take 128 * (192 + 128) = 40,960), S = ``min(window, max_seq)``
under a sliding window (a ring, slot ``pos % S``). Where JAX returns an
updated copy (``dynamic_update_slice``), ``mla_decode`` writes the
token's latents into the given cache IN PLACE (``index_copy_``) at a slot
computed on the device from the 0-d ``pos`` tensor, so a captured decode
step replays it.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, chunked_attention
from repro_torch.models.layers import apply_rope, rmsnorm_apply, trunc_normal
from repro_torch.sharding.constrain import constrain, index_copy_


def mla_init(gen, cfg, dtype, stack=()):
    d = cfg.d_model
    H, ql, kl = cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dev = gen.device
    return {
        "w_dq": trunc_normal(gen, (*stack, d, ql), d ** -0.5, dtype),
        "q_norm_g": torch.ones((*stack, ql), dtype=dtype, device=dev),
        "w_uq": trunc_normal(gen, (*stack, ql, H, nope + rope), ql ** -0.5,
                             dtype),
        "w_dkv": trunc_normal(gen, (*stack, d, kl), d ** -0.5, dtype),
        "kv_norm_g": torch.ones((*stack, kl), dtype=dtype, device=dev),
        "w_kr": trunc_normal(gen, (*stack, d, rope), d ** -0.5, dtype),
        "w_uk": trunc_normal(gen, (*stack, kl, H, nope), kl ** -0.5, dtype),
        "w_uv": trunc_normal(gen, (*stack, kl, H, vh), kl ** -0.5, dtype),
        "w_o": trunc_normal(gen, (*stack, H, vh, d), (H * vh) ** -0.5,
                            dtype),
    }


def _latents(p, x, cfg, positions):
    """-> q_eff (B,S,H,kl+rope), c_kv (B,S,kl), k_rope (B,S,rope)."""
    nope = cfg.qk_nope_dim
    cq = rmsnorm_apply({"g": p["q_norm_g"]}, x @ p["w_dq"], cfg.norm_eps)
    ql, H, e = p["w_uq"].shape
    q = (cq @ p["w_uq"].reshape(ql, H * e)).view(*cq.shape[:-1], H, e)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    # absorb: q_eff_latent = q_nope @ W_uk  -> (B,S,H,kl)
    q_eff = torch.einsum("bshn,khn->bshk", q_nope, p["w_uk"])
    c_kv = rmsnorm_apply({"g": p["kv_norm_g"]}, x @ p["w_dkv"],
                         cfg.norm_eps)
    k_rope = apply_rope(x @ p["w_kr"], positions, cfg.rope_theta)
    return torch.cat([q_eff, q_rope], -1), c_kv, k_rope


def _out_proj(p, o_latent, cfg):
    """o_latent: (B,S,H,kl) -> (B,S,D) via per-head W_uv then W_o."""
    o = torch.einsum("bshk,khv->bshv", o_latent, p["w_uv"])
    H, vh, d = p["w_o"].shape
    return o.reshape(*o.shape[:2], H * vh) @ p["w_o"].reshape(H * vh, d)


def _scale(cfg):
    return (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5


def mla_apply(p, x, cfg, positions, impl="ref"):
    """Training / prefill forward -> (y, (c_kv, k_rope)). ``impl`` is
    accepted and ignored, as in the reference: the latent attention is
    ``chunked_attention`` over one shared KV head."""
    del impl
    q_all, c_kv, k_rope = _latents(p, x, cfg, positions)
    kv = torch.cat([c_kv, k_rope], -1)[:, :, None, :]      # (B,S,1,kl+r)
    v = c_kv[:, :, None, :]                                # (B,S,1,kl)
    o_latent = chunked_attention(q_all, kv, v, n_kv_heads=1,
                                 window=cfg.window,
                                 softmax_scale=_scale(cfg))
    return _out_proj(p, o_latent, cfg), (c_kv, k_rope)


def mla_cache_init(cfg, batch, seq_len, dtype, device, stack=()):
    """Zeros ``{"c_kv": (*stack,B,S,kl), "k_rope": (*stack,B,S,rope)}``."""
    S = min(cfg.window, seq_len) if cfg.window else seq_len
    return mla_cache_reset_({
        "c_kv": torch.empty((*stack, batch, S, cfg.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_rope": torch.empty((*stack, batch, S, cfg.qk_rope_dim),
                              dtype=dtype, device=device)})


def mla_cache_reset_(cache):
    """Write ``mla_cache_init``'s values (zeros) into ``cache`` in place."""
    cache["c_kv"].zero_()
    cache["k_rope"].zero_()
    return cache


def mla_decode(p, x, cfg, cache, pos):
    """x: (B,1,D); pos: 0-d int tensor. Writes this token's ``c_kv`` and
    ``k_rope`` into ``cache`` in place; returns (y, cache)."""
    B = x.shape[0]
    cc, cr = cache["c_kv"], cache["k_rope"]
    S = cc.shape[1]
    positions = pos.reshape(1, 1).expand(B, 1)
    q_all, c_kv, k_rope = _latents(p, x, cfg, positions)
    slot = torch.remainder(pos, S) if cfg.window else pos
    idx = slot.reshape(1).long()
    index_copy_(cc, 1, idx, c_kv.to(cc.dtype))
    index_copy_(cr, 1, idx, k_rope.to(cr.dtype))
    # the cache's latent dims may lie over model: whole before the concat
    kv = torch.cat([constrain(cc, (None, None, "r")),
                    constrain(cr, (None, None, "r"))], -1)  # (B,S,kl+r)
    qh = (q_all * _scale(cfg))[:, 0]                       # (B,H,kl+r)
    dt = torch.promote_types(qh.dtype, kv.dtype)
    s = torch.einsum("bhd,bsd->bhs", qh.to(dt), kv.to(dt)).float()
    idx_s = torch.arange(S, device=x.device)
    valid = ((idx_s <= pos) | (pos >= S)) if cfg.window else (idx_s <= pos)
    s = torch.where(valid[None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_latent = torch.einsum("bhs,bsk->bhk", w.to(cc.dtype), cc)[:, None]
    return _out_proj(p, o_latent, cfg), cache
