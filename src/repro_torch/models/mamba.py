"""Mamba selective-SSM block, ported from ``repro/models/mamba.py``
(Jamba's recurrent mixer, arXiv:2403.19887).

``selective_scan_ref`` is the plain recurrence: a Python loop over time
with the discretisation inside the step, so (B,S,di,st) is never
materialised. Without autograd it updates the state in place; under
autograd it runs the reference's functional step through
``layers.chunked_scan``, whose backward pass keeps the (B,di,st) state
only every 256 steps and recomputes each chunk, as the reference's does.
``mamba_apply(impl="kernel")`` — the
JAX ``impl="pallas"`` — runs the scan through ``kernels.ops.
selective_scan``: the hand-written K6 kernel for CUDA tensors, the plain
recurrence on the CPU.

Decode keeps O(1) state per layer: ``{"conv": (B, K-1, di)}``, the last
K-1 inputs of the causal conv in the cache's dtype, and ``{"ssm": (B, di,
st)}`` f32. Where JAX returns a new state, ``mamba_decode`` updates the
given one IN PLACE; it runs the plain one-step scan, as the reference
does. ``pos`` is unused, as in the reference.

On DTensors ``d_inner`` stays over ``model`` (the reference's hint) and
the scan runs on each rank's channels and batch rows
(``constrain.local_call``: DTensor has no rule for the loop's in-place
steps); a decode's SSM state is written back in its own placement.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (chunked_scan, needs_grad, trips,
                                       trunc_normal)
from repro_torch.sharding.constrain import constrain, local_call

IMPLS = ("ref", "kernel")
_F32 = torch.float32
# local_call specs of the scan: channels over model, rows over the batch
_CH, _ROW = ("dp", None, "model"), ("dp", None, None)
_SCAN_IN = (_CH, _CH, _ROW, _ROW, ("model", None), ("model",))
_STATE = ("dp", "model", None)


def mamba_init(gen, cfg, dtype, stack=()):
    """``A_log`` and ``D`` are f32 whatever ``dtype``; the ``dt_proj``
    bias is -4.6 (softplus^-1(0.01))."""
    d, di = cfg.d_model, cfg.d_inner_ssm
    st, dtr, K = cfg.ssm_state_dim, cfg.dt_rank, cfg.ssm_conv_dim
    dev = gen.device
    a_log = torch.log(torch.arange(1, st + 1, dtype=_F32, device=dev))
    return {
        "in_proj": trunc_normal(gen, (*stack, d, 2 * di), d ** -0.5, dtype),
        "conv_w": trunc_normal(gen, (*stack, K, di), K ** -0.5, dtype),
        "conv_b": torch.zeros((*stack, di), dtype=dtype, device=dev),
        "x_proj": trunc_normal(gen, (*stack, di, dtr + 2 * st), di ** -0.5,
                               dtype),
        "dt_proj": {"w": trunc_normal(gen, (*stack, dtr, di), dtr ** -0.5,
                                      dtype),
                    "b": torch.full((*stack, di), -4.6, dtype=dtype,
                                    device=dev)},
        "A_log": a_log.expand(*stack, di, st).contiguous(),
        "D": torch.ones((*stack, di), dtype=_F32, device=dev),
        "out_proj": trunc_normal(gen, (*stack, di, d), di ** -0.5, dtype),
    }


def _ssm_inputs(p, xc, cfg):
    """xc: (B,S,di) post-conv. Returns dt (B,S,di) f32, Bm/Cm (B,S,st) f32
    (contiguous), A (di,st)."""
    st, dtr = cfg.ssm_state_dim, cfg.dt_rank
    proj = xc @ p["x_proj"]
    dt_in, Bm, Cm = torch.split(proj, [dtr, st, st], dim=-1)
    dt = dt_in @ p["dt_proj"]["w"] + p["dt_proj"]["b"]
    dt = F.softplus(dt.float())
    A = -torch.exp(p["A_log"])                                 # (di,st)
    return dt, Bm.float().contiguous(), Cm.float().contiguous(), A


def _ssm_step(A):
    """The reference's step for the decay rates ``A``, functional."""
    def step(h, inp):
        dt_t, B_t, C_t, x_t = inp                  # (B,di) / (B,st) / (B,di)
        dt_t = dt_t[..., None]                                 # (B,di,1)
        dA = torch.exp(dt_t * A)                               # (B,di,st)
        dBx = dt_t * B_t[:, None, :] * x_t[..., None]
        h = h * dA + dBx
        return h, torch.einsum("bds,bs->bd", h, C_t)
    return step


def selective_scan_ref(xc, dt, Bm, Cm, A, D, h0=None):
    """Sequential selective scan. xc: (B,S,di) -> (y (B,S,di) f32, h
    (B,di,st) f32). ``h0`` (B,di,st) f32 is the starting state, updated in
    place and returned, or None (zeros). Under autograd (an input that
    requires grad: training) the steps run through ``chunked_scan``, with
    the same arithmetic, and each state is a new tensor; ``h0`` must then
    be None."""
    B, S, di = xc.shape
    st = A.shape[-1]
    xf = xc.float()
    grad = needs_grad(xc, dt, Bm, Cm, A, D)
    if grad and h0 is not None:
        raise ValueError("selective_scan_ref updates h0 in place, which "
                         "autograd cannot differentiate; pass h0=None")
    h = (torch.zeros((B, di, st), dtype=_F32, device=xc.device)
         if h0 is None else h0)
    if grad:
        h, ys = chunked_scan(_ssm_step(A), h, tuple(
            t.transpose(0, 1) for t in (dt, Bm, Cm, xf)))
        return ys.transpose(0, 1) + xf * D, h
    ys = torch.empty((B, S, di), dtype=_F32, device=xc.device)
    for t in trips(S, xc):
        dt_t = dt[:, t, :, None]                               # (B,di,1)
        # discretisation inside the step: (B,S,di,st) is never built
        dA = torch.exp(dt_t * A)                               # (B,di,st)
        dBx = dt_t * Bm[:, t, None, :] * xf[:, t, :, None]
        h.mul_(dA).add_(dBx)
        ys[:, t] = torch.einsum("bds,bs->bd", h, Cm[:, t])
    return ys + xf * D, h


def _causal_conv(p, x, state=None):
    """x: (B,S,di); depthwise causal conv (kernel K) as an explicit sum
    over the taps in the reference's order. state: (B,K-1,di) or None.
    Returns (out, the last K-1 inputs)."""
    K = p["conv_w"].shape[0]
    pad = state if state is not None else torch.zeros(
        (x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)                            # (B,S+K-1,di)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return out + p["conv_b"], new_state


def mamba_apply(p, x, cfg, impl="ref"):
    """Training / prefill. x: (B,S,D) -> (B,S,D). ``impl="kernel"`` runs
    the scan through ``kernels.ops.selective_scan`` (K6 on the card),
    ``"ref"`` through ``selective_scan_ref``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    di = cfg.d_inner_ssm
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    xi = constrain(xi, (None, None, "model"))   # d_inner stays TP-sharded
    xc, _ = _causal_conv(p, xi)
    xc = F.silu(xc.float()).to(x.dtype)
    dt, Bm, Cm, A = _ssm_inputs(p, xc, cfg)
    if impl == "kernel":
        y, _ = kops.selective_scan(xc, dt, Bm, Cm, A, p["D"])
    else:
        y, _ = local_call(selective_scan_ref, (xc, dt, Bm, Cm, A, p["D"]),
                          _SCAN_IN, (_CH, _STATE))
    y = y * F.silu(z.float())
    return y.to(x.dtype) @ p["out_proj"]


def mamba_state_init(cfg, batch, dtype, device, stack=()):
    """Zero conv tail (``dtype``) and SSM state (f32, as in the
    reference), each with a leading ``stack`` dim."""
    di, st, K = cfg.d_inner_ssm, cfg.ssm_state_dim, cfg.ssm_conv_dim
    return mamba_state_reset_(
        {"conv": torch.empty((*stack, batch, K - 1, di), dtype=dtype,
                             device=device),
         "ssm": torch.empty((*stack, batch, di, st), dtype=_F32,
                            device=device)})


def mamba_state_reset_(state):
    """Write ``mamba_state_init``'s values (zeros) into ``state`` in
    place."""
    state["conv"].zero_()
    state["ssm"].zero_()
    return state


def mamba_decode(p, x, cfg, state, pos):
    """x: (B,1,D); ``state`` is updated in place. Returns (y, state)."""
    di = cfg.d_inner_ssm
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    xc, conv_tail = _causal_conv(p, xi, state["conv"])
    state["conv"].copy_(conv_tail)
    xc = F.silu(xc.float()).to(x.dtype)
    dt, Bm, Cm, A = _ssm_inputs(p, xc, cfg)
    y, _ = local_call(selective_scan_ref,
                      (xc, dt, Bm, Cm, A, p["D"], state["ssm"]),
                      _SCAN_IN + (_STATE,), (_CH, _STATE), inplace=(6,))
    y = y * F.silu(z.float())
    return y.to(x.dtype) @ p["out_proj"], state
