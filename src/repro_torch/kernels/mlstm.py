"""mLSTM forward — K7, the stabilized matrix-memory recurrence of xLSTM.

Ports ``repro/kernels/mlstm.py``. ``mlstm_fwd`` is the wrapper of the
hand-written CUDA kernel in ``csrc/mlstm.cu``: CUDA tensors only, checked,
the output allocated here, launched on the current stream, launches
counted in ``.launches``. Its plain version is ``ref.mlstm_ref`` (which is
``models.xlstm.mlstm_cell_ref``); ``ops.mlstm`` picks between them by the
tensors' device.

Forward only, as the reference is: there is no backward kernel, and the
model trains through ``mlstm_cell_ref``. The kernel runs the recurrence in
its chunkwise-parallel form (chunks of ``CHUNK`` steps, products on the
tensor cores in 3xTF32; see the source's notes), so it takes any S and any
hd up to ``HD_MAX``: the TPU ``chunk`` (``S % chunk == 0``) is not carried
over. Its scratch, ``scratch_floats`` f32 values, holds C at every chunk
start but the first: about (S / 128) hd^2 floats per (batch, head), 2.0 GB
at xlstm-1.3b's (8, 2048, 4, 1024).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import _check_rc, _ptr, _require, _stream

HD_MAX = 1024
CHUNK = 128         # steps per chunk (csrc/mlstm.cu L)
_TILE = 64          # state tile width (csrc/mlstm.cu TS)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def scratch_floats(B, S, H, hd):
    """f32 values of K7's scratch, in csrc/mlstm.cu ``launch``'s layout: C
    and n at chunk starts 1.., the weighted intra-chunk scores G, then F, m,
    i and the denominator per step. hd is padded to a multiple of 64."""
    nc, hdp, bh = -(-S // CHUNK), -(-hd // _TILE) * _TILE, B * H
    return bh * ((nc - 1) * hdp * (hdp + 1) + nc * CHUNK * CHUNK + 4 * S)


def mlstm_fwd(q, k, v, ig, fg):
    """CUDA q,k,v: (B,S,H,hd) f32 or bf16; ig,fg: (B,S,H) raw gates, f32
    or bf16 -> h: (B,S,H,hd) f32. q and k are scaled by hd^-1/4 inside.
    Launches ``mlstm_fwd`` (K7)."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, ig, fg)):
        raise RuntimeError(
            "mlstm_fwd is forward only (the reference has no backward "
            "kernel); train through mlstm_cell_ref")
    for name, t in (("q", q), ("ig", ig)):
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16; got "
                             f"{t.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t, name, q.dtype, ndim=4)
    for name, t in (("ig", ig), ("fg", fg)):
        _require(t, name, ig.dtype, ndim=3)
    B, S, H, hd = q.shape
    if (k.shape != q.shape or v.shape != q.shape
            or ig.shape != (B, S, H) or fg.shape != (B, S, H)):
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, ig {tuple(ig.shape)}, fg {tuple(fg.shape)}: "
            "want (B,S,H,hd) three times and (B,S,H) twice")
    if any(t.device != q.device for t in (k, v, ig, fg)):
        raise ValueError("q, k, v, ig and fg must lie on one device")
    if hd > HD_MAX:
        raise NotImplementedError(
            f"head size {hd} > {HD_MAX}: the chunkwise kernel's scratch "
            f"holds (S / {CHUNK}) hd^2 floats per (batch, head), and xLSTM's "
            "largest head is 1024")
    nc, nt = -(-S // CHUNK), -(-hd // _TILE)
    if B * H * nt * max(nt, nc) >= 2 ** 31:
        raise ValueError(f"B={B}, S={S}, H={H}, hd={hd}: more than 2^31 - 1 "
                         "thread blocks in one launch")
    h = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    if h.numel():
        from repro_torch.kernels._build import load
        scratch = torch.empty(scratch_floats(B, S, H, hd),
                              dtype=torch.float32, device=q.device)
        rc = load("mlstm").mlstm_fwd(
            _ptr(q), _ptr(k), _ptr(v), _ptr(ig), _ptr(fg), _ptr(h),
            _ptr(scratch), _DTYPES[q.dtype], _DTYPES[ig.dtype], B, S, H, hd,
            float(hd ** -0.25), _stream(q))
        _check_rc(rc, "mlstm_fwd")
        mlstm_fwd.launches += 1
    return h


mlstm_fwd.launches = 0
