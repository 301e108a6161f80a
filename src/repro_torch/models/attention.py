"""GQA attention, training path, ported from ``repro/models/attention.py``.

``chunked_attention`` computes what the JAX function of the same name
computes: q is scaled by ``hd**-0.5`` before the product, kv head
``h // (H/KV)`` serves query head ``h`` (``repeat_interleave``), scores
are f32 with an additive ``-1e30`` causal mask, and the online softmax
runs over ``chunk_q x chunk_kv`` blocks and divides by ``max(l, 1e-30)``.
It is plain tensor code (matmul, exp), not
``F.scaled_dot_product_attention``; the hand-written flash-attention
kernel (``repro/kernels/flash_attention.py``) is still to port, and with
it the decode path.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, trunc_normal

NEG_INF = -1e30


def attn_init(gen, cfg, dtype, stack=()):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": trunc_normal(gen, (*stack, d, H, hd), d ** -0.5, dtype),
        "wk": trunc_normal(gen, (*stack, d, KV, hd), d ** -0.5, dtype),
        "wv": trunc_normal(gen, (*stack, d, KV, hd), d ** -0.5, dtype),
        "wo": trunc_normal(gen, (*stack, H, hd, d), (H * hd) ** -0.5, dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros((*stack, heads, hd), dtype=dtype,
                                  device=gen.device)
    return p


def _proj(x, w):
    """einsum('bsd,dhk->bshk') as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _qkv(p, x, cfg, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def mask_bias(q_pos, k_pos, window):
    """(Sq,Sk) additive mask: causal, optional sliding window."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, NEG_INF)


def _chunk(S, target):
    """Largest divisor of S that is <= target."""
    c = min(target, S)
    while S % c:
        c -= 1
    return c


def chunked_attention(q, k, v, *, n_kv_heads, window=0, q_offset=0,
                      chunk_q=1024, chunk_kv=1024, softmax_scale=None):
    """Online-softmax causal attention. q:(B,Sq,H,hd) k,v:(B,Sk,KV,hd)
    -> (B,Sq,H,hd_v) in q's dtype. The peak score tensor is
    (B,H,cq,ck) whatever the sequence length."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    hd_v = v.shape[-1]
    scale = softmax_scale or hd ** -0.5
    cq, ck = _chunk(Sq, chunk_q), _chunk(Sk, chunk_kv)
    G = H // n_kv_heads
    dev = q.device

    qh = (q * scale).transpose(1, 2)                        # (B,H,Sq,hd)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)      # (B,H,Sk,hd)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)      # (B,H,Sk,hd_v)
    outs = []
    for i0 in range(0, Sq, cq):
        qi = qh[:, :, i0:i0 + cq]
        q_pos = q_offset + i0 + torch.arange(cq, device=dev)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, hd_v), dtype=torch.float32, device=dev)
        for j0 in range(0, Sk, ck):
            kc, vc = kh[:, :, j0:j0 + ck], vh[:, :, j0:j0 + ck]
            k_pos = j0 + torch.arange(ck, device=dev)
            s = (qi @ kc.transpose(-1, -2)).float()
            s = s + mask_bias(q_pos, k_pos, window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + (p.to(vc.dtype) @ vc).float()
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2).transpose(1, 2)            # (B,Sq,H,hd_v)
    return out.to(q.dtype)


def attn_apply(p, x, cfg, positions):
    """Training forward. x: (B,S,D) -> (B,S,D), plus (k, v)."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = chunked_attention(q, k, v, n_kv_heads=cfg.n_kv_heads,
                            window=cfg.window)
    H, hd, d = p["wo"].shape
    y = out.reshape(*out.shape[:2], H * hd) @ p["wo"].reshape(H * hd, d)
    return y, (k, v)
