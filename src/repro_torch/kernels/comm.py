"""Fused quantize -> average -> dequantize — K3 and K4, the Eq. 2 wire pass.

Ports ``repro/kernels/comm.py``. One pass over the flat-buffer codec's
``(K, N_pad)`` stacked participant buffer (``core/flatbuf.py``): every
participant row is quantized with its own f32 scale per 256-wide block
(the ``quantize.py`` wire format at ``bits ∈ {8, 4, 1}``), dequantized,
and reduced to the Eq. 2 mean. ``quant_avg_dequant_ef_fwd`` is the
error-feedback variant: it quantizes ``x + e`` and also returns the new
residual ``e' = (x + e) - dequant(quant(x + e))``.

Both are wrappers of the hand-written CUDA kernels in ``csrc/wire.cu``
(``wire_quant_avg_dequant``, ``wire_quant_avg_dequant_ef``): CUDA tensors
only, checked, outputs allocated here, launches counted in ``.launches``.
``n`` is padded up to whole blocks (the flat codec's ``N_pad`` already
is, so the pad is a no-op on the hot path); zero pad stays exactly zero.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.quantize import (DEFAULT_BLOCK, _check_rc, _ptr,
                                          _require, _require_block, _stream,
                                          check_bits)


def _padded(buf, block):
    n = buf.shape[1]
    n_pad = -(-n // block) * block
    return (buf if n_pad == n else F.pad(buf, (0, n_pad - n))), n_pad


def quant_avg_dequant_fwd(buf, *, block=DEFAULT_BLOCK, bits=8):
    """CUDA buf (K, n) f32 -> (n,) f32 mean of the wire-roundtripped rows.
    Launches ``wire_quant_avg_dequant`` (K3)."""
    from repro_torch.kernels._build import load
    check_bits(bits)
    _require_block(block)
    _require(buf, "buf", torch.float32, ndim=2)
    K, n = buf.shape
    xb, n_pad = _padded(buf, block)
    out = torch.empty((n_pad,), dtype=torch.float32, device=buf.device)
    if K and n_pad:
        rc = load().wire_quant_avg_dequant(_ptr(xb), _ptr(out), K, n_pad,
                                           bits, _stream(buf))
        _check_rc(rc, "wire_quant_avg_dequant")
        quant_avg_dequant_fwd.launches += 1
    return out[:n]


quant_avg_dequant_fwd.launches = 0


def quant_avg_dequant_ef_fwd(buf, residual, *, block=DEFAULT_BLOCK, bits=8):
    """CUDA (buf, residual) both (K, n) f32 -> ((n,) mean of the
    roundtripped ``buf + residual`` rows, new residual). The kernel writes
    the new residual over ``residual`` IN PLACE (each element is read once,
    by the thread that then writes it) and returns it. Launches
    ``wire_quant_avg_dequant_ef`` (K4)."""
    from repro_torch.kernels._build import load
    check_bits(bits)
    _require_block(block)
    _require(buf, "buf", torch.float32, ndim=2)
    _require(residual, "residual", torch.float32, ndim=2)
    if residual.shape != buf.shape or residual.device != buf.device:
        raise ValueError(f"residual {tuple(residual.shape)} on "
                         f"{residual.device} must match buf "
                         f"{tuple(buf.shape)} on {buf.device}")
    K, n = buf.shape
    xb, n_pad = _padded(buf, block)
    eb, _ = _padded(residual, block)
    out = torch.empty((n_pad,), dtype=torch.float32, device=buf.device)
    if K and n_pad:
        rc = load().wire_quant_avg_dequant_ef(_ptr(xb), _ptr(eb), _ptr(out),
                                              _ptr(eb), K, n_pad, bits,
                                              _stream(buf))
        _check_rc(rc, "wire_quant_avg_dequant_ef")
        quant_avg_dequant_ef_fwd.launches += 1
    if eb is not residual:
        residual.copy_(eb[:, :n])
    return out[:n], residual


quant_avg_dequant_ef_fwd.launches = 0
