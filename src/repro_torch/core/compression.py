"""Blockwise-quantized model averaging (wire emulation), ported from
``repro/core/compression.py``.

The paper does not compress uploads; the quantized wire is a separately
reported optimization. ``quantize_roundtrip`` is the leafwise path and
``quantize_roundtrip_ef`` its error-feedback form: every STACKED
``(K, ...)`` leaf is quantize-roundtripped as one array (so, as in the
JAX package, a block may straddle two participants mid-leaf), and leaves
smaller than one block travel uncompressed. ``LeafwiseIntN.encode`` /
``decode`` in ``core/api.py`` is the same roundtrip as a codec, which
the runners use; ``make_compress_fn`` wraps ``quantize_roundtrip`` as a
``compress_fn``, as in the reference. The flat-buffer
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


def quantize_roundtrip(tree, block=256, bits=8):
    """Quantize then dequantize every leaf (the compressed upload);
    bypassed leaves are returned unchanged."""
    return unflatten_like(tree, [
        t if _bypass(t, block) else kops.dequantize_blockwise(
            *kops.quantize_blockwise(t, block=block, bits=bits),
            bits=bits).to(t.dtype)
        for t in leaves(tree)])


def make_compress_fn(block=256, bits=8):
    """``compress_fn(stacked)``: ``quantize_roundtrip`` of the stacked
    tree. The reference's ``impl`` has no counterpart: the kernels
    dispatch on the tensors' device."""
    def fn(stacked):
        return quantize_roundtrip(stacked, block=block, bits=bits)
    return fn


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
