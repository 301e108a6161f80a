"""Flash attention forward — K5, causal with an optional sliding window.

Ports ``repro/kernels/flash_attention.py``. ``flash_attention_fwd`` is the
wrapper of the hand-written CUDA kernel in ``csrc/flash_attention.cu``:
CUDA tensors only, checked, the output allocated here, launched on the
current stream, launches counted in ``.launches``. Its plain version is
``ref.flash_attention_ref``; ``ops.flash_attention`` picks between them by
the tensors' device.

Forward only, as the reference is: there is no backward kernel, and the
model trains through ``models.attention.chunked_attention``. The TPU
tiling (``block_q`` / ``block_k``) is not carried over: a block serves 128
query rows of the heads that share one KV head and walks 64-key tiles,
both products on the tensor cores in 3xTF32 (f32-accurate; bf16 inputs
are widened to f32), and ragged tails are masked, so no length needs to
be a multiple of a tile. Head sizes run up to ``HD_MAX`` (128), the
widest tile a block keeps in shared memory. Query rows must not outnumber
keys (``Sq <= Sk``): a row before the first key would see no key at all.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import _check_rc, _ptr, _require, _stream

HD_MAX = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd(q, k, v, *, n_kv_heads, window=0,
                        softmax_scale=None):
    """CUDA q: (B,Sq,H,hd), k: (B,Sk,KV,hd), v: (B,Sk,KV,hd_v) -> (B,Sq,H,
    hd_v) in q's dtype. Launches ``flash_attention_fwd`` (K5)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_fwd is forward only (the reference has no "
            "backward kernel); train through chunked_attention")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16; got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t, name, q.dtype, ndim=4)
    B, Sq, H, hd = q.shape
    Sk, KV, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if (k.shape != (B, Sk, KV, hd) or v.shape[:3] != (B, Sk, KV)
            or KV != n_kv_heads or H % KV):
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} with n_kv_heads={n_kv_heads}: want "
            "(B,Sq,H,hd), (B,Sk,KV,hd), (B,Sk,KV,hd_v) with KV dividing H")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v must lie on one device")
    if max(hd, hd_v) > HD_MAX:
        raise NotImplementedError(
            f"head sizes above {HD_MAX} (hd={hd}, hd_v={hd_v}) are outside "
            "this kernel: a block keeps 128 query rows and a 64-key tile of "
            "K and V, 128 wide, in shared memory (MLA's 576-wide latent "
            "attention runs through models.attention.chunked_attention, as "
            "in the reference)")
    if Sq > Sk:
        raise ValueError(f"Sq={Sq} > Sk={Sk}: the first query rows would "
                         "see no key")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B} and H={H} must each be <= 65535 (grid)")
    scale = softmax_scale or hd ** -0.5
    out = torch.empty((B, Sq, H, hd_v), dtype=q.dtype, device=q.device)
    if out.numel():
        from repro_torch.kernels._build import load
        rc = load("flash_attention").flash_attention_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _DTYPES[q.dtype], B, Sq,
            Sk, H, KV, hd, hd_v, int(window), float(scale), _stream(q))
        _check_rc(rc, "flash_attention_fwd")
        flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
