"""Single-token decode attention — K8, over the KV cache in place.

``decode_attention_fwd`` is the wrapper of the hand-written CUDA kernel in
``csrc/decode_attention.cu``: CUDA tensors only, checked, the output and
the kernel's scratch allocated here, launched on the current stream,
launches counted in ``.launches``. Its plain version is
``ref.decode_attention_ref``; ``ops.decode_attention`` picks between them
by the tensors' device.

It replaces no TPU kernel: the JAX package's decode is plain ``jnp``, and
XLA fuses the repeat of K and V to every query head into the dot. The
kernel reads each valid slot of the cache once, up to the position, which
it reads from device memory, so one captured decode step serves every
position. Forward only, f32 only (scores, softmax and sums in f32, no
TF32), G = H/KV of 1 to ``G_MAX`` and head sizes that are multiples of 4
up to ``HD_MAX``: the port's configurations.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import _check_rc, _ptr, _require, _stream

CHUNK = 64          # cache slots a block of the kernel (csrc CH)
G_MAX = 8
HD_MAX = 128
_POS_DTYPES = {torch.int32: 0, torch.int64: 1}


def decode_attention_fwd(q, ck, cv, pos, *, window, softmax_scale):
    """CUDA q: (B,1,H,hd), ck/cv: (B,S,KV,hd) f32, pos: 0-d int tensor on
    the same card -> (B,1,H,hd). Launches ``decode_attention_fwd`` (K8).
    ``window`` is the cache's sliding window (0: none); the valid slots
    are ``min(pos + 1, S)`` with or without it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, ck, cv)):
        raise RuntimeError(
            "decode_attention_fwd is forward only: decode runs without "
            "autograd")
    for name, t in (("q", q), ("ck", ck), ("cv", cv)):
        if t.dtype != torch.float32 or t.ndim != 4:
            raise ValueError(f"{name} must be a 4-D float32 tensor; got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    B, one, H, hd = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    if one != 1 or ck.shape != (B, S, KV, hd) or cv.shape != ck.shape \
            or H % KV or S < 1:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, ck {tuple(ck.shape)}, cv "
            f"{tuple(cv.shape)}: want (B,1,H,hd) and (B,S,KV,hd) twice, "
            "with KV dividing H and S >= 1")
    if pos.ndim != 0 or pos.dtype not in _POS_DTYPES:
        raise ValueError(f"pos must be a 0-d int32 or int64 tensor; got "
                         f"{pos.dtype} of shape {tuple(pos.shape)}")
    if H // KV > G_MAX or hd > HD_MAX or hd % 4:
        raise ValueError(
            f"G = H/KV = {H // KV} and hd = {hd} are outside this kernel: "
            f"G <= {G_MAX} query heads a KV head, hd a multiple of 4 up to "
            f"{HD_MAX} (a row is loaded as 16-byte vectors by hd/4 lanes)")
    if window < 0:
        raise ValueError(f"window must be >= 0; got {window}")
    for name, t in (("q", q), ("ck", ck), ("cv", cv)):
        _require(t, name, torch.float32)
    if len({q.device, ck.device, cv.device, pos.device}) != 1:
        raise ValueError("q, ck, cv and pos must lie on one device")
    if any(t.data_ptr() % 16 for t in (q, ck, cv)):
        raise ValueError("q, ck and cv must be 16-byte aligned")
    if B * KV > 65535:
        raise ValueError(f"B*KV = {B * KV} must be <= 65535 (grid)")
    out = torch.empty((B, 1, H, hd), dtype=torch.float32, device=q.device)
    if out.numel():
        nsplit = -(-S // CHUNK)
        # per (b, KV head, chunk): the G heads' unnormalised P·V, then
        # (max, sum) per head
        part = torch.empty(B * KV * nsplit * (H // KV) * (hd + 2),
                           dtype=torch.float32, device=q.device)
        from repro_torch.kernels._build import load
        rc = load("decode_attention").decode_attention_fwd(
            _ptr(q), _ptr(ck), _ptr(cv), _ptr(pos), _POS_DTYPES[pos.dtype],
            _ptr(out), _ptr(part), B, S, H, KV, hd, float(softmax_scale),
            _stream(q))
        _check_rc(rc, "decode_attention_fwd")
        decode_attention_fwd.launches += 1
    return out


decode_attention_fwd.launches = 0
