"""Plain PyTorch versions of the wire kernels K1-K4, flash attention K5,
the Mamba selective scan K6, the mLSTM recurrence K7 and decode
attention K8.

The wire versions repeat ``repro/kernels/ref.py`` (``_code_blocks_ref`` ..
``quant_avg_dequant_ef_ref``) op for op: absmax or mean-|x| per 256-wide
row, ``x / scale`` (a division, never a reciprocal multiply), round half to
even, clip, then ``q * scale``; Eq. 2 is ``sum over K / K``. The wrappers
in ``ops.py`` use them for CPU tensors only; on the card they are the
reference each kernel is held against.

Where a JAX oracle materialises int8 codes and widens them again, the
dequantize-only paths here keep the clipped rounded quotient in f32 and
scale it in place: the values are integers of at most 127 in magnitude,
so the result is the same number, and a ``(K, N_pad)`` buffer at full
width needs one temporary of its size instead of four.

``flash_attention_ref`` repeats ``repro/kernels/ref.py``
``flash_attention_ref``: it materialises the whole score matrix.
``decode_attention_ref`` is the JAX package's ``decode_attend``
(``repro/models/attention.py``) op for op: K and V repeated to every
query head (``repeat_kv``) over the whole cache, scores masked past the
position, a softmax and a product, so the CPU parity tests see the JAX
package's numbers. ``selective_scan_ref`` and ``mlstm_ref`` name
``models.mamba.selective_scan_ref`` and ``models.xlstm.mlstm_cell_ref``,
as the reference's do, so each plain recurrence exists once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import QMAX, check_bits, pack_codes, \
    unpack_codes

NEG_INF = -1e30


def _div(a, v):
    """``a / v`` as an elementwise IEEE division. PyTorch's CUDA kernel
    turns division by a Python scalar into a multiply by its reciprocal,
    which can round differently; a 0-d tensor divisor keeps the division
    the JAX oracle and the CUDA kernels compute."""
    return a / torch.full((), v, dtype=a.dtype, device=a.device)


def _row_scale(xb, bits):
    """Per-row scale over the last dim, keepdim: mean|x| at 1 bit, else
    amax/qmax (1.0 for an all-zero row)."""
    if bits == 1:
        return xb.abs().mean(dim=-1, keepdim=True)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    return torch.where(amax > 0, _div(amax, QMAX[bits]), 1.0)


def _codes_f32(xb, scale, bits):
    """clip(round(x / scale)) as f32 (exact small integers)."""
    if bits == 1:
        one = torch.ones((), dtype=xb.dtype, device=xb.device)
        return torch.where(xb > 0, one, -one)
    qmax = QMAX[bits]
    return torch.div(xb, scale).round_().clamp_(-qmax, qmax)


def _code_blocks_ref(blocks, bits):
    """(nb, block) f32 -> (codes int8, scale (nb,)) for bits in {8, 4, 1}."""
    scale = _row_scale(blocks, bits)
    return _codes_f32(blocks, scale, bits).to(torch.int8), scale[:, 0]


def _blocks(flat, block):
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block)


def quantize_blockwise_ref(x, block=256, bits=8):
    """x: any shape -> (q packed (nblocks, block*bits//8), scale f32
    (nblocks,), shape). No ROWS padding of the row count."""
    check_bits(bits)
    blocks = _blocks(x.to(torch.float32).reshape(-1), block)
    q, scale = _code_blocks_ref(blocks, bits)
    return pack_codes(q, bits), scale, tuple(x.shape)


def dequantize_blockwise_ref(q, scale, shape, bits=8):
    check_bits(bits)
    q = unpack_codes(q, bits)
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape))


def _roundtrip_rows_ref(xb, bits):
    """(K, nb, block) f32 -> dequantized wire roundtrip, same shape."""
    scale = _row_scale(xb, bits)
    return _codes_f32(xb, scale, bits).mul_(scale)


def _pad_rows(buf, block):
    K, n = buf.shape
    pad = (-n) % block
    if pad:
        buf = F.pad(buf, (0, pad))
    return buf.reshape(K, -1, block)


def quant_avg_dequant_ref(buf, block=256, bits=8):
    """buf: (K, n) f32 -> (n,) f32 — wire-roundtrip every participant row
    blockwise (one scale per (participant, block)), then Eq. 2 mean."""
    check_bits(bits)
    K, n = buf.shape
    dq = _roundtrip_rows_ref(_pad_rows(buf, block), bits)
    return _div(torch.sum(dq, dim=0), K).reshape(-1)[:n]


def quant_avg_dequant_ef_ref(buf, residual, block=256, bits=8):
    """Error-feedback version: quantize ``buf + residual`` per row; return
    (Eq. 2 mean of the dequantized rows (n,), new residual (K, n)). The
    residual is updated in place (first to ``y``, then to ``y - dq``) and
    returned, as the CUDA kernel does."""
    check_bits(bits)
    if residual.shape != buf.shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != buf "
                         f"shape {tuple(buf.shape)}")
    K, n = buf.shape
    yb = _pad_rows(residual.add_(buf), block)   # y = e + x, held in e
    dq = _roundtrip_rows_ref(yb, bits)
    mean = _div(torch.sum(dq, dim=0), K).reshape(-1)[:n]
    yb.sub_(dq)
    if yb.data_ptr() != residual.data_ptr():   # padded copy: write back
        residual.copy_(yb.reshape(K, -1)[:, :n])
    return mean, residual


def flash_attention_ref(q, k, v, *, n_kv_heads, window=0, softmax_scale=None):
    """q: (B,Sq,H,hd), k/v: (B,Sk,KV,hd*) -> (B,Sq,H,hd_v). Causal, with
    query row i at key position i + (Sk - Sq); masked scores are -1e30;
    f32 scores and softmax, the result in q's dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], n_kv_heads
    G = H // KV
    scale = softmax_scale or hd ** -0.5
    qg = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * scale, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def repeat_kv(k, n_heads):
    """(B,S,KV,hd) -> (B,S,H,hd), kv head ``h // (H/KV)`` for head h."""
    B, S, KV, hd = k.shape
    if KV == n_heads:
        return k
    G = n_heads // KV
    return k[:, :, :, None, :].expand(B, S, KV, G, hd).reshape(
        B, S, n_heads, hd)


def decode_attention_ref(q, ck, cv, pos, *, window, softmax_scale):
    """q: (B,1,H,hd); ck/cv: (B,S,KV,hd); pos: 0-d int tensor. Single-token
    attention over the slots up to ``pos`` (every slot once a sliding
    window's ring has wrapped) -> (B,1,H,hd_v)."""
    H = q.shape[2]
    S = ck.shape[1]
    qh = q[:, 0] * softmax_scale                           # (B,H,hd)
    k2 = repeat_kv(ck, H)                                  # (B,S,H,hd)
    v2 = repeat_kv(cv, H)
    dt = torch.promote_types(qh.dtype, k2.dtype)
    s = torch.einsum("bhd,bshd->bhs", qh.to(dt), k2.to(dt)).float()
    idx = torch.arange(S, device=q.device)
    valid = ((idx <= pos) | (pos >= S)) if window else (idx <= pos)
    s = torch.where(valid[None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", w.to(v2.dtype), v2)
    return out[:, None]                                    # (B,1,H,hd_v)


def selective_scan_ref(xc, dt, Bm, Cm, A, D, h0=None):
    """Sequential Mamba scan; identical math to models.mamba."""
    from repro_torch.models.mamba import selective_scan_ref as _impl
    return _impl(xc, dt, Bm, Cm, A, D, h0)


def mlstm_ref(q, k, v, ig, fg, state=None):
    """Sequential stabilized mLSTM; identical math to models.xlstm."""
    from repro_torch.models.xlstm import mlstm_cell_ref
    return mlstm_cell_ref(q, k, v, ig, fg, state)
