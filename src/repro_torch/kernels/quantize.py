"""Blockwise sub-f32 quantize / dequantize — K1 and K2 of the wire format.

Ports ``repro/kernels/quantize.py``. The wire supports ``bits ∈ {8, 4, 1}``:

* 8 / 4 — symmetric absmax quantization to ``qmax = 2**(bits-1) - 1``
  integer codes (127 / 7) with one f32 scale per 256-wide block row (1.0
  for an all-zero row); int4 codes are packed two per byte.
* 1 — sign codes (x <= 0 -> -1) packed eight per byte, scale
  ``mean(|x|)`` per row (0 for an all-zero row, so zero padding stays 0).

``quantize_blockwise_fwd`` / ``dequantize_blockwise_fwd`` are the wrappers
of the hand-written CUDA kernels in ``csrc/wire.cu`` (``wire_quantize``,
``wire_dequantize``). They take CUDA tensors only, check what they are
given, allocate the outputs and count their launches in ``.launches``.
Bit-packing stays plain torch outside the kernels (``pack_codes`` /
``unpack_codes``), shared with the plain versions in ``ref.py``, so both
produce the identical packed payload. As in the JAX kernel, the quantizer
pads its row count to a multiple of ``ROWS``; the plain version does not.
"""
from __future__ import annotations

import ctypes

import torch

DEFAULT_BLOCK = 256
ROWS = 8

# symmetric-integer code range per bit width (1-bit is sign-coded, not here)
QMAX = {8: 127.0, 4: 7.0}


def check_bits(bits):
    if bits not in (8, 4, 1):
        raise ValueError(f"bits must be 8, 4, or 1; got {bits}")


def packed_width(block, bits):
    """Payload columns of one packed block row."""
    check_bits(bits)
    return block * bits // 8


def pack_codes(q, bits):
    """(nb, block) int8 codes -> (nb, block*bits//8) packed payload.

    bits=8 is the identity; bits=4 packs two's-complement nibbles (even
    index = low nibble); bits=1 packs eight sign bits per byte (LSB =
    lowest index, set bit = +1).
    """
    check_bits(bits)
    if bits == 8:
        return q
    if bits == 4:
        u = q.view(torch.uint8) & 0xF
        return u[:, 0::2] | (u[:, 1::2] << 4)
    b = (q > 0).to(torch.uint8).reshape(q.shape[0], -1, 8)
    # bit i of each byte, built on q's device (no host transfer)
    shift = torch.arange(8, dtype=torch.uint8, device=q.device)
    return (b << shift).sum(dim=2).to(torch.uint8)


def unpack_codes(p, bits):
    """Exact inverse of ``pack_codes``: packed payload -> int8 codes."""
    check_bits(bits)
    if bits == 8:
        return p
    if bits == 4:
        u = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(p.shape[0], -1)
        s = u.to(torch.int8)
        return torch.where(s > 7, s - 16, s)
    w = torch.arange(8, dtype=torch.uint8, device=p.device)
    b = (p[:, :, None] >> w) & 1
    one = torch.ones((), dtype=torch.int8, device=p.device)
    return torch.where(b == 1, one, -one).reshape(p.shape[0], -1)


# ---------------------------------------------------------------------------
# wrapper checks shared with comm.py
# ---------------------------------------------------------------------------
def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require(t, name, dtype, ndim=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor; got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}; got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D; got shape "
                         f"{tuple(t.shape)}")


def _require_block(block):
    if block != DEFAULT_BLOCK:
        raise ValueError(f"the CUDA wire kernels take block={DEFAULT_BLOCK}; "
                         f"got {block}")


def _check_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError {rc}")


def quantize_blockwise_fwd(x, *, block=DEFAULT_BLOCK, bits=8):
    """CUDA x: any shape -> (q packed (nb, block*bits//8), scale f32 (nb,),
    shape), ``nb`` = ceil(n/block) rounded up to a multiple of ``ROWS``.
    Launches ``wire_quantize`` (K1)."""
    from repro_torch.kernels._build import load
    check_bits(bits)
    _require_block(block)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor; got {x.device}")
    flat = x.reshape(-1).to(torch.float32).contiguous()
    n = flat.numel()
    nb = -(-n // block)
    nb = -(-nb // ROWS) * ROWS
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((nb,), dtype=torch.float32, device=x.device)
    rc = load().wire_quantize(_ptr(flat), _ptr(q), _ptr(scale), n, nb, bits,
                              _stream(x))
    _check_rc(rc, "wire_quantize")
    quantize_blockwise_fwd.launches += 1
    return pack_codes(q, bits), scale, tuple(x.shape)


quantize_blockwise_fwd.launches = 0


def dequantize_blockwise_fwd(q, scale, shape, *, bits=8):
    """CUDA packed payload (nb, ·) + scale (nb,) -> f32 tensor of ``shape``.
    Any ``nb`` is accepted (no row is dropped). Launches
    ``wire_dequantize`` (K2)."""
    from repro_torch.kernels._build import load
    check_bits(bits)
    codes = unpack_codes(q, bits).contiguous()
    _require(codes, "q", torch.int8, ndim=2)
    _require(scale, "scale", torch.float32, ndim=1)
    nb, block = codes.shape
    _require_block(block)
    if scale.shape != (nb,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({nb},)")
    n = 1
    for s in shape:
        n *= s
    if n > nb * block:
        raise ValueError(f"shape {shape} needs {n} elements; payload has "
                         f"only {nb}x{block}")
    out = torch.empty(tuple(shape), dtype=torch.float32, device=q.device)
    if n:
        rc = load().wire_dequantize(_ptr(codes), _ptr(scale), _ptr(out), n,
                                    _stream(q))
        _check_rc(rc, "wire_dequantize")
        dequantize_blockwise_fwd.launches += 1
    return out


dequantize_blockwise_fwd.launches = 0
