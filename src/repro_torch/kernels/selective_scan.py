"""Mamba selective scan forward — K6, the recurrence of Jamba's Mamba layers.

Ports ``repro/kernels/selective_scan.py``. ``selective_scan_fwd`` is the
wrapper of the hand-written CUDA kernel in ``csrc/selective_scan.cu``:
CUDA tensors only, checked, the outputs allocated here, launched on the
current stream, launches counted in ``.launches``. Its plain version is
``ref.selective_scan_ref`` (which is ``models.mamba.selective_scan_ref``);
``ops.selective_scan`` picks between them by the tensors' device.

Forward only, from a zero state, as the TPU kernel is: decode runs the
plain one-step scan from the cached state, as the reference does. The TPU
tiling (``block_d`` / ``chunk``, with ``di % block_d == 0`` and
``S % chunk == 0``) is not carried over: the kernel takes any S and di.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import _check_rc, _ptr, _require, _stream

STATE_DIMS = (4, 8, 16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def selective_scan_fwd(xc, dt, Bm, Cm, A, D):
    """CUDA xc: (B,S,di) f32 or bf16; dt: (B,S,di) f32 (the softplus
    output, f32 in ``models.mamba``); Bm, Cm: (B,S,st) f32; A: (di,st)
    f32; D: (di,) f32 -> (y (B,S,di) f32, h_final (B,di,st) f32), with
    B, S, di >= 1. Launches ``selective_scan_fwd`` (K6)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xc, dt, Bm, Cm, A, D)):
        raise RuntimeError(
            "selective_scan_fwd is forward only (the reference has no "
            "backward kernel); train through selective_scan_ref")
    if xc.dtype not in _DTYPES:
        raise ValueError(f"xc must be float32 or bfloat16; got {xc.dtype}")
    _require(xc, "xc", xc.dtype, ndim=3)
    for name, t, nd in (("dt", dt, 3), ("Bm", Bm, 3), ("Cm", Cm, 3),
                        ("A", A, 2), ("D", D, 1)):
        _require(t, name, torch.float32, ndim=nd)
    B, S, di = xc.shape
    st = A.shape[-1]
    if (dt.shape != xc.shape or Bm.shape != (B, S, st)
            or Cm.shape != (B, S, st) or A.shape != (di, st)
            or D.shape != (di,)):
        raise ValueError(
            f"shapes xc {tuple(xc.shape)}, dt {tuple(dt.shape)}, Bm "
            f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, A {tuple(A.shape)}, "
            f"D {tuple(D.shape)}: want (B,S,di) twice, (B,S,st) twice, "
            "(di,st) and (di,)")
    if any(t.device != xc.device for t in (dt, Bm, Cm, A, D)):
        raise ValueError("xc, dt, Bm, Cm, A and D must lie on one device")
    if st not in STATE_DIMS:
        raise NotImplementedError(
            f"state size {st} not in {STATE_DIMS}: the kernel keeps the "
            "states in registers at a compile-time size")
    if B > 65535 or S > 2 ** 31 - 17 or di > 2 ** 28:
        raise ValueError(f"B={B}, S={S}, di={di}: the kernel takes B <= "
                         "65535 (grid), S < 2^31 - 16 and di <= 2^28 "
                         "(32-bit step offsets)")
    y = torch.empty((B, S, di), dtype=torch.float32, device=xc.device)
    h = torch.empty((B, di, st), dtype=torch.float32, device=xc.device)
    from repro_torch.kernels._build import load
    rc = load("selective_scan").selective_scan_fwd(
        _ptr(xc), _ptr(dt), _ptr(Bm), _ptr(Cm), _ptr(A), _ptr(D), _ptr(y),
        _ptr(h), _DTYPES[xc.dtype], B, S, di, st,
        _stream(xc))
    _check_rc(rc, "selective_scan_fwd")
    selective_scan_fwd.launches += 1
    return y, h


selective_scan_fwd.launches = 0
