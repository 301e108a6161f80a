"""Blockwise-quantized model averaging (wire emulation), ported from
``repro/core/compression.py``.

The paper does not compress uploads; the quantized wire is a separately
reported optimization. ``quantize_roundtrip_ef`` is the leafwise path
with error feedback: every STACKED ``(K, ...)`` leaf is
quantize-roundtripped as one array (so, as in the JAX package, a block
may straddle two participants mid-leaf), and leaves smaller than one
block travel uncompressed. Without error feedback the same roundtrip is
``LeafwiseIntN.encode``/``decode`` in ``core/api.py``. The flat-buffer
path lives in ``core/flatbuf.py`` + ``kernels/comm.py``.

On CUDA tensors the roundtrip launches K1 and K2 once per leaf.
"""
from __future__ import annotations

from repro_torch.core import flatbuf
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quantize import check_bits
from repro_torch.tree import leaves, unflatten_like


def _bypass(t, block):
    return t.ndim == 0 or t.numel() < block


def quantize_roundtrip_ef(tree, residual, block=256, bits=8):
    """Error-feedback leafwise roundtrip: quantize ``t + e`` per leaf and
    return ``(roundtripped tree, new residual tree)`` with
    ``e' = (t + e) - dequant``; bypassed leaves pass through unchanged
    with their residual."""
    out, res = [], []
    for t, e in zip(leaves(tree), leaves(residual)):
        if _bypass(t, block):
            out.append(t)
            res.append(e)
            continue
        y = t.float() + e
        q, scale, shape = kops.quantize_blockwise(y, block=block, bits=bits)
        dq = kops.dequantize_blockwise(q, scale, shape, bits=bits)
        out.append(dq.to(t.dtype))
        res.append(y - dq)
    return unflatten_like(tree, out), unflatten_like(residual, res)


def block_bytes(block, bits, scale_bytes=4):
    """Wire bytes of ONE encoded block: packed payload + its scale."""
    check_bits(bits)
    return block * bits // 8 + scale_bytes


def compressed_bytes(tree, block=256, bits=8, scale_bytes=4):
    """Per-participant wire bytes of the leafwise encoding of ONE
    participant's (unstacked) params: ``ceil(n/block)`` packed blocks plus
    a scale each per quantized leaf; sub-block leaves at raw size."""
    per_block = block_bytes(block, bits, scale_bytes)
    total = 0
    for t in leaves(tree):
        n = t.numel()
        if t.ndim == 0 or n < block:
            total += n * t.element_size()
        else:
            total += (-(-n // block)) * per_block
    return total


def flat_compressed_bytes(tree, block=256, bits=8, scale_bytes=4):
    """Exact per-participant wire bytes of the flat-buffer codec for a
    STACKED tree."""
    return flatbuf.wire_bytes(flatbuf.make_layout(tree, block=block),
                              bits=bits, scale_bytes=scale_bytes)
