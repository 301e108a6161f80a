"""Plain PyTorch reference of the blockwise wire codec: a tensor's values
in blocks of ``block`` (zero-padded at its end), one scale a block
(``max|x| / qmax``, 1 for an all-zero block), each value divided by its
scale (a true division), rounded half to even, clipped to ``±qmax`` and
multiplied back."""
from __future__ import annotations

import torch
import torch.nn.functional as F

QMAX = {8: 127.0, 4: 7.0}


@torch.no_grad()
def roundtrip(x, block=256, bits=8):
    """``x`` through the wire and back (same shape, f32)."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    blocks = F.pad(flat, (0, (-n) % block)).reshape(-1, block)
    qmax = torch.tensor(QMAX[bits], device=x.device)
    amax = blocks.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    codes = (blocks / scale).round_().clamp_(-qmax, qmax)
    return (codes * scale).reshape(-1)[:n].reshape(x.shape)
