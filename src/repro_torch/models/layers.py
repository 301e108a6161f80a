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

from repro_torch.sharding.constrain import constrain, local_call, on_mesh

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
    """``table[tokens]``. On DTensors each rank looks its rows' tokens up
    in its slice of the vocab (zeros elsewhere) and the rows come back
    pending a sum over ``model`` (``local_call``, the table gathered over
    ``data``): the lookup and its gradient stay on the rank's slice, as
    the vocab-sliced loss's do."""
    if on_mesh(tokens, p["table"]):
        table = p["table"]
        rows = ("dp",) + (None,) * (tokens.ndim - 1)

        def lookup(tab, tok):
            if tab.shape[0] == table.shape[0]:            # the vocab is whole
                return tab[tok]
            local = tok - table.device_mesh.get_local_rank("model") \
                * tab.shape[0]
            hit = (local >= 0) & (local < tab.shape[0])
            return tab[local.clamp(0, tab.shape[0] - 1)] * \
                hit[..., None].to(tab.dtype)
        return local_call(lookup, (table, tokens), (("model", None), rows),
                          rows + (None,), partial=True)
    return p["table"][tokens]


def lm_head_apply(p_embed, p_head, x, tie):
    """The logits; on DTensors each rank's rows and vocab slice
    (``local_call``, the weight gathered over ``data``)."""
    if on_mesh(x):
        rows = ("dp",) + (None,) * (x.ndim - 1)
        out = ("dp",) + (None,) * (x.ndim - 2) + ("model",)
        w, spec = ((p_embed["table"], ("model", None)) if tie
                   else (p_head["w"], (None, "model")))
        return local_call(lambda a, b: lm_head_apply(
            {"table": b}, {"w": b}, a, tie), (x, w), (rows, spec), out)
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
    """SwiGLU. On DTensors (rows over the batch axes) it runs on each
    rank's rows and hidden units: the weights gathered over ``data``
    (FSDP), d_ff over ``model``, the down product a pending sum over
    ``model`` (``local_call``; DTensor's own rule search gathered whole
    weights onto every rank at the production mesh)."""
    if on_mesh(x):
        rows = ("dp",) + (None,) * (x.ndim - 1)
        hid = ("dp",) + (None,) * (x.ndim - 2) + ("model",)
        h = local_call(_ffn_up, (x, p["wi"], p["wg"]),
                       (rows, (None, "model"), (None, "model")), hid)
        return local_call(torch.matmul, (h, p["wo"]),
                          (hid, ("model", None)), rows, partial=True)
    return _ffn_up(x, p["wi"], p["wg"]) @ p["wo"]


def _ffn_up(x, wi, wg):
    h = constrain(x @ wi, (None,) * (x.ndim - 1) + ("model",))
    g = constrain(x @ wg, (None,) * (x.ndim - 1) + ("model",))
    return F.silu(g.float()).to(x.dtype) * h


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


class _Loop:
    """The trips of a loop of ``n`` alike trips: ``range(n)``, ``pick``
    the per-trip slices of a tensor (one unbind) and ``join`` the trips'
    results (one stack or cat)."""

    def __init__(self, n):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def pick(self, x):
        return x.unbind(0)

    def join(self, parts, dim=0, stack=False):
        return (torch.stack if stack else torch.cat)(parts, dim)


def trips(n, *tensors):
    """The trips of a loop of ``n`` trips over ``tensors`` that run the
    same ops on the same shapes. Outside a cost count it is a plain
    :class:`_Loop`. While a dispatch mode that books repeated trips is
    active (``launch/dryrun.CostMode``: its ``trips``) and the tensors
    are on ``meta``, with ``n > 3``, the mode's loop runs trips 0, 1 and
    n - 1 and books trip 1 as ``n - 2`` (``pick`` and ``join`` then give
    the same ops as the whole loop's, on its full shapes)."""
    if n > 3 and tensors and all(t.device.type == "meta" for t in tensors):
        from torch.utils._python_dispatch import \
            _get_current_dispatch_mode_stack
        for mode in reversed(_get_current_dispatch_mode_stack()):
            book = getattr(mode, "trips", None)
            if book is not None:
                return book(n)
    return _Loop(n)


def _scan(step, carry, xs):
    # one unbind per input: its backward is one stack, where indexing
    # each step would zero, copy and add a whole-length gradient a step
    ts = xs if isinstance(xs, tuple) else (xs,)
    loop = trips(len(ts[0]), *ts)
    seq = list(zip(*(loop.pick(x) for x in ts)))
    ys = []
    for i, _ in enumerate(loop):
        carry, y = step(carry, seq[i] if isinstance(xs, tuple) else seq[i][0])
        ys.append(y)
    return carry, loop.join(ys, stack=True)


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
    be functional: it writes nothing in place. Steps and chunks are
    :func:`trips`."""
    ts = xs if isinstance(xs, tuple) else (xs,)
    S = len(ts[0])
    c = min(chunk, S)
    if S % c or c == S or not remat:
        return _scan(step, carry, xs)
    loop = trips(S // c, *ts)
    ys = []
    for k in loop:
        carry, y = checkpoint(_scan, step, carry,
                              _index(xs, slice(k * c, (k + 1) * c)),
                              use_reentrant=False, preserve_rng_state=False)
        ys.append(y)
    return carry, loop.join(ys)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------
class _VocabSliceXent(torch.autograd.Function):
    """``logsumexp - logit[label]`` per position from this rank's slice of
    the vocab: the max, the sum of exponentials and the label's logit are
    reduced over ``group`` (the ``model`` ranks), as Megatron's
    vocab-parallel cross-entropy; the gradient is the slice's own
    ``softmax - onehot``, with no traffic."""

    @staticmethod
    def forward(ctx, lf, idx, hit, group):
        import torch.distributed as dist
        m = lf.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(lf - m[..., None])
        s = e.sum(-1)
        dist.all_reduce(s, group=group)
        ll = torch.gather(lf, -1, idx[..., None])[..., 0] * hit
        dist.all_reduce(ll, group=group)
        ctx.save_for_backward(e, s, idx, hit)
        return m + torch.log(s) - ll

    @staticmethod
    def backward(ctx, g):
        e, s, idx, hit = ctx.saved_tensors
        grad = e / s[..., None]
        grad.scatter_add_(-1, idx[..., None], -hit.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def _mesh_nll(logits, labels, ignore_index):
    """Per-position ``lse - logit[label]`` of DTensor logits (rows over
    the batch axes, the vocab over ``model``) without gathering the
    vocab: DTensor's gather over a sharded vocab materialises the whole
    logits' gradient on every rank."""
    mesh, V = logits.device_mesh, logits.shape[-1]

    def nll(lg, lab):
        lf = lg.float()
        valid = lab != ignore_index
        if lf.shape[-1] == V:                      # the vocab is whole
            lse = torch.logsumexp(lf, dim=-1)
            idx = torch.where(valid, lab, 0)[..., None]
            return lse - torch.gather(lf, -1, idx)[..., 0]
        v0 = mesh.get_local_rank("model") * lf.shape[-1]
        local = torch.where(valid, lab, 0) - v0
        hit = (local >= 0) & (local < lf.shape[-1])
        return _VocabSliceXent.apply(lf, local.clamp(0, lf.shape[-1] - 1),
                                     hit.to(lf.dtype),
                                     mesh.get_group("model"))
    rows = ("dp",) + (None,) * (labels.ndim - 1)
    return local_call(nll, (logits, labels), (rows + ("model",), rows),
                      rows)


def softmax_xent(logits, labels, ignore_index=-1):
    """Mean next-token cross-entropy over valid positions (f32):
    ``logsumexp - logit[label]`` where ``label != ignore_index``."""
    if on_mesh(logits):
        validf = (labels != ignore_index).float()
        nll = _mesh_nll(logits, labels, ignore_index) * validf
        return nll.sum() / torch.clamp(validf.sum(), min=1.0)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    valid = labels != ignore_index
    ll = torch.gather(lf, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
    validf = valid.float()
    nll = (lse - ll) * validf
    return nll.sum() / torch.clamp(validf.sum(), min=1.0)
