"""GQA attention, ported from ``repro/models/attention.py``: the
training / prefill forward and the one-token KV-cache decode.

``chunked_attention`` computes what the JAX function of the same name
computes: q is scaled by ``hd**-0.5`` before the product, kv head
``h // (H/KV)`` serves query head ``h`` (``repeat_interleave``), scores
are f32 with an additive ``-1e30`` causal mask, and the online softmax
runs over ``chunk_q x chunk_kv`` blocks and divides by ``max(l, 1e-30)``.
It is plain tensor code (matmul, exp), not
``F.scaled_dot_product_attention``. ``attn_apply(impl="kernel")`` routes
through ``kernels.ops.flash_attention`` instead: the hand-written K5 kernel
for CUDA tensors (forward only), its plain version on the CPU.

Decode: the cache of one layer is ``{"k", "v"}`` of shape (B,S,KV,hd),
S = ``min(window, max_seq)`` under a sliding window (a ring buffer, slot
``pos % S``) and ``max_seq`` otherwise. Where JAX returns an updated copy
(``dynamic_update_slice``), ``attn_decode`` writes the new key and value
into the given cache IN PLACE (``index_copy_``) and returns it. ``pos`` is
a 0-d tensor on the model's device, read there, so a decode step never
waits for the host. ``decode_attend`` runs through
``kernels.ops.decode_attention``: on the card K8, which reads the cache in
place up to the position; on the CPU its plain version, the JAX
package's arithmetic (K and V repeated to every head, a mask, a softmax).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, trips, trunc_normal
from repro_torch.sharding.constrain import (axis_size, constrain, index_copy_,
                                           local_call, on_mesh)

NEG_INF = -1e30
_HEADS = (None, None, "model", None)        # (B,S,H,hd): heads over model


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
    """einsum('bsd,dhk->bshk') as one matmul over the flattened heads. On
    DTensors it runs on each rank's rows and heads (``local_call``, the
    weight gathered over ``data``: FSDP): DTensor may shard the flat
    (h·k) dim over ``model`` where the heads do not split, and cannot then
    view it as heads."""
    if on_mesh(x, w):
        return local_call(_proj, (x, w), (("dp", None, None),
                                          (None, "model", None)),
                          ("dp", None, "model", None))
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


def _repeat_heads(k, G):
    """(B,S,KV,hd) -> (B,S,H,hd) by ``repeat_interleave``; H over
    model."""
    return k if G == 1 else constrain(k.repeat_interleave(G, dim=2),
                                      _HEADS)


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
    (B,H,cq,ck) whatever the sequence length. KV == 1 takes the
    shared-KV (MQA / MLA) path, which never repeats k and v.

    On DTensors the whole computation runs on each rank's rows and
    heads (``constrain.local_call``), the placement the reference's hints
    pin (heads over ``model``), the kv heads repeated first where they do
    not split over ``model``: DTensor's rule search for a batched matmul
    grows with the power of the mesh's rank, minutes a product on a
    three-axis mesh."""
    if on_mesh(q, k, v):
        return _mesh_attention(q, k, v, n_kv_heads, window=window,
                               q_offset=q_offset, chunk_q=chunk_q,
                               chunk_kv=chunk_kv,
                               softmax_scale=softmax_scale)
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    hd_v = v.shape[-1]
    scale = softmax_scale or hd ** -0.5
    cq, ck = _chunk(Sq, chunk_q), _chunk(Sk, chunk_kv)
    G = H // n_kv_heads
    dev = q.device
    if n_kv_heads == 1:
        return _shared_kv_attention(q * scale, k[:, :, 0], v[:, :, 0],
                                    window, q_offset, cq, ck)

    qh = constrain(q * scale, _HEADS).transpose(1, 2)       # (B,H,Sq,hd)
    kh = _repeat_heads(k, G).transpose(1, 2)                # (B,H,Sk,hd)
    vh = _repeat_heads(v, G).transpose(1, 2)                # (B,H,Sk,hd_v)
    rows, outs = trips(Sq // cq, q), []
    for i in rows:
        i0 = i * cq
        qi = qh[:, :, i0:i0 + cq]
        q_pos = q_offset + i0 + torch.arange(cq, device=dev)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, cq, hd_v), dtype=torch.float32, device=dev)
        for j in trips(Sk // ck, k):
            j0 = j * ck
            kc, vc = kh[:, :, j0:j0 + ck], vh[:, :, j0:j0 + ck]
            k_pos = j0 + torch.arange(ck, device=dev)
            s = constrain((qi @ kc.transpose(-1, -2)).float(),
                          (None, "model", None, None))
            s = s + mask_bias(q_pos, k_pos, window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + (p.to(vc.dtype) @ vc).float()
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = rows.join(outs, dim=2).transpose(1, 2)            # (B,Sq,H,hd_v)
    return out.to(q.dtype)


def _shared_kv_attention(q, k, v, window, q_offset, cq, ck):
    """``chunked_attention`` over one KV head shared by every query head:
    q (B,Sq,H,hd), already scaled; k (B,Sk,hd); v (B,Sk,hd_v). Each chunk
    folds the heads into the rows of one batched product, (B, cq*H, hd)
    by (B, hd, ck), so k and v are read as they are: at MLA's full width
    (128 heads, 576 wide) a repeated k alone would be 128 times the
    latent cache."""
    B, Sq, H, hd = q.shape
    Sk, hd_v = k.shape[1], v.shape[-1]
    dev = q.device
    rows, outs = trips(Sq // cq, q), []
    for i in rows:
        i0 = i * cq
        qi = q[:, i0:i0 + cq].reshape(B, cq * H, hd)
        q_pos = q_offset + i0 + torch.arange(cq, device=dev)
        m = torch.full((B, cq, H), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, cq, H), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, cq, H, hd_v), dtype=torch.float32, device=dev)
        for j in trips(Sk // ck, k):
            j0 = j * ck
            kc, vc = k[:, j0:j0 + ck], v[:, j0:j0 + ck]
            k_pos = j0 + torch.arange(ck, device=dev)
            s = (qi @ kc.transpose(-1, -2)).float().view(B, cq, H, ck)
            s = s + mask_bias(q_pos, k_pos, window)[:, None, :]
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = p.to(vc.dtype).view(B, cq * H, ck) @ vc
            acc = acc * corr[..., None] + pv.float().view(B, cq, H, hd_v)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return rows.join(outs, dim=1).to(q.dtype)               # (B,Sq,H,hd_v)


_ROWS_HEADS = ("dp", None, "model", None)


def _local_kv(q, k, v, n_kv_heads):
    """k, v as ``local_call`` takes them beside q, and their spec: kv
    heads over ``model`` where they split, repeated to q's heads where
    they do not, whole for a shared kv head."""
    H = q.shape[2]
    if n_kv_heads == 1:
        return k, v, ("dp", None, None, None)
    if n_kv_heads % axis_size(q, "model"):
        G = H // n_kv_heads
        k, v = _repeat_heads(k, G), _repeat_heads(v, G)
    return k, v, _ROWS_HEADS


def _mesh_attention(q, k, v, n_kv_heads, **kw):
    k, v, kv_spec = _local_kv(q, k, v, n_kv_heads)
    return local_call(
        lambda a, b, c: chunked_attention(a, b, c, n_kv_heads=b.shape[2],
                                          **kw),
        (q, k, v), (_ROWS_HEADS, kv_spec, kv_spec), _ROWS_HEADS)


def _out_proj(out, wo):
    """einsum('bshk,hkd->bsd') as one matmul, in the promoted dtype; on
    DTensors each rank's rows and heads, a pending sum over ``model``."""
    if on_mesh(out, wo):
        return local_call(_out_proj, (out, wo),
                          (_ROWS_HEADS, ("model", None, None)),
                          ("dp", None, None), partial=True)
    H, hd, d = wo.shape
    dt = torch.promote_types(out.dtype, wo.dtype)
    return out.reshape(*out.shape[:2], H * hd).to(dt) @ \
        wo.reshape(H * hd, d).to(dt)


IMPLS = ("ref", "kernel")


def attn_apply(p, x, cfg, positions, impl="ref"):
    """Training / prefill forward. x: (B,S,D) -> (B,S,D), plus (k, v).

    ``impl="ref"`` is ``chunked_attention``; ``impl="kernel"`` is
    ``kernels.ops.flash_attention`` (K5), the counterpart of the JAX
    package's ``impl="pallas"``. K5 is forward only."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    q, k, v = _qkv(p, x, cfg, positions)
    if impl == "kernel":
        out = kops.flash_attention(q, k, v, n_kv_heads=cfg.n_kv_heads,
                                   window=cfg.window)
    else:
        out = chunked_attention(q, k, v, n_kv_heads=cfg.n_kv_heads,
                                window=cfg.window)
    return _out_proj(out, p["wo"]), (k, v)


# --------------------------------------------------------------------------
# Decode (one token, KV cache; ring buffer when cfg.window > 0)
# --------------------------------------------------------------------------
def attn_cache_init(cfg, batch, seq_len, dtype, device, stack=()):
    """Zeros ``{"k", "v"}`` of shape (*stack, B, S, KV, hd)."""
    S = min(cfg.window, seq_len) if cfg.window else seq_len
    shp = (*stack, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return attn_cache_reset_({"k": torch.empty(shp, dtype=dtype,
                                               device=device),
                              "v": torch.empty(shp, dtype=dtype,
                                               device=device)})


def attn_cache_reset_(cache):
    """Write ``attn_cache_init``'s values (zeros) into ``cache`` in place."""
    cache["k"].zero_()
    cache["v"].zero_()
    return cache


def decode_attend(q, ck, cv, pos, *, window, softmax_scale):
    """q: (B,1,H,hd); ck/cv: (B,S,KV,hd); pos: 0-d tensor. Single-token
    attention -> (B,1,H,hd_v) through ``kernels.ops.decode_attention``:
    K8 over the cache in place on the card, the plain version (the JAX
    package's arithmetic) on the CPU. On DTensors each rank's rows and
    heads (``local_call``: DTensor's einsum cannot flatten a head-sharded
    cache under torch 2.11), the cache's heads laid out as q's."""
    if on_mesh(q, ck, cv):
        k, v, kv_spec = _local_kv(q, ck, cv, ck.shape[2])
        return local_call(
            lambda a, b, c: decode_attend(a, b, c, pos, window=window,
                                          softmax_scale=softmax_scale),
            (q, k, v), (_ROWS_HEADS, kv_spec, kv_spec), _ROWS_HEADS)
    return kops.decode_attention(q, ck, cv, pos, window=window,
                                 softmax_scale=softmax_scale)


def attn_decode(p, x, cfg, cache, pos):
    """x: (B,1,D); pos: 0-d int tensor, the current position. Writes this
    token's k and v into ``cache`` in place; returns (y, cache)."""
    B = x.shape[0]
    S = cache["k"].shape[1]
    positions = pos.reshape(1, 1).expand(B, 1)
    q, k, v = _qkv(p, x, cfg, positions)                   # k,v: (B,1,KV,hd)
    slot = torch.remainder(pos, S) if cfg.window else pos
    idx = slot.reshape(1).long()
    index_copy_(cache["k"], 1, idx, k.to(cache["k"].dtype))
    index_copy_(cache["v"], 1, idx, v.to(cache["v"].dtype))
    out = decode_attend(q, cache["k"], cache["v"], pos, window=cfg.window,
                        softmax_scale=cfg.head_dim ** -0.5)
    return _out_proj(out, p["wo"]), cache
