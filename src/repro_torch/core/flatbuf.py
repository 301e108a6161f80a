"""Flat-buffer wire codec, ported from ``repro/core/flatbuf.py``.

``make_layout(stacked)`` computes the static table (offsets, trailing
shapes, dtypes) that maps every leaf of a stacked ``(K, ...)`` params tree
into one ``(K, N_pad)`` f32 buffer: leaves in JAX order, each at a
``block``-aligned offset (zero fill between leaves, so a quantization
block never straddles two leaves), ``N_pad`` rounded up to whole
``rows x block`` tiles. The offsets, ``n`` and ``n_pad`` equal the JAX
layout's for the same tree, so ``flatten`` gives the JAX buffer element
for element.

``unflatten_mean(mean, layout, out=stacked)`` writes the averaged
``(N_pad,)`` buffer into the existing stacked params IN PLACE (each leaf
``copy_`` from a broadcast view): at full width a materialised
``(K, N_pad)`` broadcast would cost another K model copies.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.kernels.quantize import DEFAULT_BLOCK, ROWS, check_bits
from repro_torch.tree import leaves as tree_leaves
from repro_torch.tree import unflatten_like

# dtypes the f32 wire container holds losslessly (bit-exact roundtrip)
_WIRE_DTYPES = frozenset((torch.float32, torch.bfloat16, torch.float16))


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static wire layout of one stacked params tree structure (shapes
    only; never holds tensor data)."""
    like: Any                        # the stacked tree (structure source)
    shapes: tuple                    # per-leaf trailing shape (K stripped)
    dtypes: tuple                    # per-leaf original dtype
    offsets: tuple                   # per-leaf start offset in the buffer
    sizes: tuple                     # per-leaf element count (per participant)
    k: int                           # leading participant dim shared by leaves
    n: int                           # block-aligned payload end per row
    n_pad: int                       # n rounded up to rows*block tiles
    block: int
    rows: int


def make_layout(stacked, *, block: int = DEFAULT_BLOCK,
                rows: int = ROWS) -> FlatLayout:
    """Layout for a stacked tree whose every leaf has leading dim K."""
    leaves = tree_leaves(stacked)
    if not leaves:
        raise ValueError("cannot build a flat layout for an empty tree")
    k = leaves[0].shape[0] if leaves[0].ndim else 0
    shapes, dtypes, offsets, sizes = [], [], [], []
    off = 0
    for leaf in leaves:
        if leaf.ndim == 0 or leaf.shape[0] != k:
            raise ValueError(
                f"every leaf must share the leading participant dim {k}; "
                f"got shape {tuple(leaf.shape)}")
        if leaf.dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"dtype {leaf.dtype} does not roundtrip bit-exactly "
                f"through the f32 wire container")
        size = int(math.prod(leaf.shape[1:]))
        shapes.append(tuple(leaf.shape[1:]))
        dtypes.append(leaf.dtype)
        offsets.append(off)
        sizes.append(size)
        off += -(-size // block) * block          # next leaf block-aligned
    tile = rows * block
    n_pad = -(-off // tile) * tile
    return FlatLayout(like=stacked, shapes=tuple(shapes),
                      dtypes=tuple(dtypes), offsets=tuple(offsets),
                      sizes=tuple(sizes), k=k, n=off, n_pad=n_pad,
                      block=block, rows=rows)


def flatten(stacked, layout: FlatLayout):
    """Stacked tree -> one contiguous ``(K, N_pad)`` f32 buffer (zero
    padding between leaves and at the tail)."""
    leaves = tree_leaves(stacked)
    buf = torch.zeros((layout.k, layout.n_pad), dtype=torch.float32,
                      device=leaves[0].device)
    for leaf, off, size in zip(leaves, layout.offsets, layout.sizes):
        buf[:, off:off + size].copy_(leaf.reshape(layout.k, size))
    return buf


def unflatten(buf, layout: FlatLayout):
    """Exact inverse of ``flatten``: ``(K, N_pad)`` buffer -> new stacked
    tree."""
    leaves = [
        buf[:, off:off + size].reshape(layout.k, *shape).to(dt, copy=True)
        for off, size, shape, dt in zip(layout.offsets, layout.sizes,
                                        layout.shapes, layout.dtypes)
    ]
    return unflatten_like(layout.like, leaves)


def unflatten_mean(mean, layout: FlatLayout, out, live=None):
    """Write the ``(N_pad,)`` averaged buffer into all K slots of ``out``
    (a stacked tree of this layout) IN PLACE and return ``out`` (the
    ``average_fn`` contract). ``live`` (a ``(K,)`` liveness row): only the
    live slots are written, a dead slot keeps its value."""
    for dst, off, size, shape in zip(tree_leaves(out), layout.offsets,
                                     layout.sizes, layout.shapes):
        m = mean[off:off + size].reshape(shape)[None].expand(
            layout.k, *shape)
        if live is None:
            dst.copy_(m)
        else:
            alive = (live > 0).reshape((-1,) + (1,) * len(shape))
            dst.copy_(torch.where(alive, m.to(dst.dtype), dst))
    return out


def wire_bytes(layout: FlatLayout, bits: int = 8,
               scale_bytes: int = 4) -> int:
    """Exact bytes one participant puts on the wire for this layout: the
    packed ``bits``-wide payload of every (padded) element plus one
    ``scale_bytes``-wide scale per block row."""
    check_bits(bits)
    return (layout.n_pad * bits) // 8 + scale_bytes * (
        layout.n_pad // layout.block)
