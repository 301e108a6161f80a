"""Core layers, ported from ``repro/models/layers.py``: norms, RoPE,
embeddings, the dense SwiGLU FFN, the chunk-recomputed scan of the
recurrences and the LM loss.

Functional style over plain dicts: ``*_init`` builds a params dict
(optionally with a stacked leading ``repeats`` dim), ``*_apply`` consumes
it. Norms and the loss accumulate in f32. Random numbers come from an
explicit ``torch.Generator`` whose device is where the tensors are made.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

_SQRT2 = math.sqrt(2.0)


def trunc_normal(gen, shape, scale, dtype):
    """Fan-in scaled init: ``scale`` times a standard normal truncated to
    ±2σ (inverse-CDF sampling, as ``jax.random.truncated_normal`` does).
    Every step works in place on the uniform draw, so a leaf's transient
    peak is the leaf itself (an f32 expert leaf of a full-width MoE is
    15-18 GB)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
    hi = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0).erfinv_().mul_(_SQRT2)
    return u.clamp_(-2.0, 2.0).mul_(scale).to(dtype)


def dense_init(gen, d_in, d_out, dtype, stack=(), bias=False):
    p = {"w": trunc_normal(gen, (*stack, d_in, d_out), d_in ** -0.5, dtype)}
    if bias:
        p["b"] = torch.zeros((*stack, d_out), dtype=dtype, device=gen.device)
    return p


def dense_apply(p, x):
    """``x @ w`` (+ ``b``). The reference's ``prec`` (an XLA matmul
    precision) has no counterpart: a matmul runs at torch's own precision
    settings."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------
def rmsnorm_init(d, dtype, stack=(), device=None):
    return {"g": torch.ones((*stack, d), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["g"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embedding (half-split, not interleaved)
# --------------------------------------------------------------------------
def rope_freqs(head_dim, theta, device=None):
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    ang = positions[..., None].float() * inv               # (..., S, hd/2)
    if x.ndim == ang.ndim + 1:                             # has a heads dim
        ang = ang[..., None, :]                            # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Embedding + LM head
# --------------------------------------------------------------------------
def embed_init(gen, vocab, d, dtype):
    return {"table": trunc_normal(gen, (vocab, d), d ** -0.5, dtype)}


def embed_apply(p, tokens):
    return p["table"][tokens]


def lm_head_apply(p_embed, p_head, x, tie):
    if tie:
        return torch.einsum("...d,vd->...v", x, p_embed["table"])
    return x @ p_head["w"]


# --------------------------------------------------------------------------
# Dense FFN (SwiGLU)
# --------------------------------------------------------------------------
def ffn_init(gen, d, d_ff, dtype, stack=()):
    return {
        "wi": trunc_normal(gen, (*stack, d, d_ff), d ** -0.5, dtype),
        "wg": trunc_normal(gen, (*stack, d, d_ff), d ** -0.5, dtype),
        "wo": trunc_normal(gen, (*stack, d_ff, d), d_ff ** -0.5, dtype),
    }


def ffn_apply(p, x):
    h = x @ p["wi"]
    g = x @ p["wg"]
    h = F.silu(g.float()).to(x.dtype) * h
    return h @ p["wo"]


# --------------------------------------------------------------------------
# Chunk-recomputed scan (the recurrences' backward pass)
# --------------------------------------------------------------------------
def needs_grad(*tensors):
    """Autograd is recording and one of ``tensors`` requires grad (a
    training step): the recurrences then run functional steps through
    ``chunked_scan`` instead of their in-place loops."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _index(xs, i):
    """``xs[i]`` of a tensor, or of each tensor of a tuple."""
    return tuple(x[i] for x in xs) if isinstance(xs, tuple) else xs[i]


def _scan(step, carry, xs):
    # one unbind per input: its backward is one stack, where indexing
    # each step would zero, copy and add a whole-length gradient a step
    seq = (tuple(zip(*(x.unbind(0) for x in xs))) if isinstance(xs, tuple)
           else xs.unbind(0))
    ys = []
    for x_t in seq:
        carry, y = step(carry, x_t)
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step, carry, xs, chunk=256, remat=True):
    """``carry, y_t = step(carry, x_t)`` over the leading (time) dim of
    ``xs`` (a tensor or a tuple of tensors); returns ``(carry, ys)``, the
    ``y_t`` (tensors) stacked on a new leading dim: ``lax.scan`` with
    gradient checkpoints every ``chunk`` steps, as the reference's
    ``chunked_scan``. Each chunk runs under ``torch.utils.checkpoint``
    (non-reentrant, no RNG state: the recurrences draw no random numbers,
    and reading the CUDA RNG state would raise inside a graph capture), so
    the backward pass keeps the carry only at chunk boundaries and
    recomputes each chunk's steps: O(S/chunk) saved carries instead of
    O(S). ``c = min(chunk, S)``; when ``c`` does not divide S, when
    ``c == S`` or with ``remat=False`` it is a plain loop. ``step`` must
    be functional: it writes nothing in place."""
    S = len(xs[0] if isinstance(xs, tuple) else xs)
    c = min(chunk, S)
    if S % c or c == S or not remat:
        return _scan(step, carry, xs)
    ys = []
    for lo in range(0, S, c):
        carry, y = checkpoint(_scan, step, carry,
                              _index(xs, slice(lo, lo + c)),
                              use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    return carry, torch.cat(ys)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------
def softmax_xent(logits, labels, ignore_index=-1):
    """Mean next-token cross-entropy over valid positions (f32):
    ``logsumexp - logit[label]`` where ``label != ignore_index``."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    valid = labels != ignore_index
    ll = torch.gather(lf, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    validf = valid.float()
    nll = (lse - ll) * validf
    return nll.sum() / torch.clamp(validf.sum(), min=1.0)
