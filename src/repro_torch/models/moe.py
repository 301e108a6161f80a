"""Token-choice top-k MoE with sort-based capacity dispatch, ported from
``repro/models/moe.py``.

Tokens are split into G dispatch groups (``n_groups``); within a group
they are argsorted by expert id (stable, as ``jnp.argsort`` is), ranked
within their expert by position arithmetic (a left ``searchsorted``), and
scattered into a static (E * capacity, D) buffer per group. Where JAX
drops an over-capacity token with ``.at[dest].set(mode="drop")`` at index
E * cap, the port scatters into an (E * cap + 1)-row buffer and cuts the
last row: every shape is static and no step asks the host a question, so
the decode step runs under ``torch.cuda.set_sync_debug_mode("error")``.
The combine is a gather and an ``index_add_`` (each token receives at most
k = 2 weighted rows, whose sum does not depend on their order). The router
runs in f32; the aux loss is the Switch E * sum f_e P_e. The expert
products are plain batched matmuls (``torch.einsum``), as the reference
leaves them to XLA; the sharding hints have no counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import trunc_normal

_F32 = torch.float32


def moe_init(gen, cfg, dtype, stack=()):
    """The router is f32 whatever ``dtype``, as in the reference."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": trunc_normal(gen, (*stack, d, E), d ** -0.5, _F32),
        "wi": trunc_normal(gen, (*stack, E, d, f), d ** -0.5, dtype),
        "wg": trunc_normal(gen, (*stack, E, d, f), d ** -0.5, dtype),
        "wo": trunc_normal(gen, (*stack, E, f, d), f ** -0.5, dtype),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "wi": trunc_normal(gen, (*stack, d, fs), d ** -0.5, dtype),
            "wg": trunc_normal(gen, (*stack, d, fs), d ** -0.5, dtype),
            "wo": trunc_normal(gen, (*stack, fs, d), fs ** -0.5, dtype),
        }
    return p


def capacity(n_tokens, cfg):
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(4, -(-c // 4) * 4)    # round up to a multiple of 4, >= 4


def n_groups(T, E):
    """Dispatch groups: largest power of two <= 64 such that every group
    still holds >= 4·E tokens (so per-group capacity stays meaningful)."""
    g = 1
    while g < 64 and T % (2 * g) == 0 and T // (2 * g) >= 4 * E:
        g *= 2
    return g


def moe_apply(p, x, cfg):
    """x: (B,S,D) -> (y (B,S,D) in x's dtype, aux_loss f32 0-d)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)

    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)                       # (T,E)
    top_p, top_i = torch.topk(probs, k, dim=-1)                 # (T,k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- grouped sort-based dispatch ---------------------------------------
    G = n_groups(T, E)
    Tg = T // G
    cap = capacity(Tg, cfg)
    xg = xt.reshape(G, Tg, D)
    ge = top_i.reshape(G, Tg * k)                               # expert ids
    gp = top_p.reshape(G, Tg * k)

    order = torch.argsort(ge, dim=1, stable=True)
    se = torch.gather(ge, 1, order)                             # sorted ids
    experts = torch.arange(E, device=x.device).expand(G, E).contiguous()
    start = torch.searchsorted(se, experts)                     # (G,E)
    rank = torch.arange(Tg * k, device=x.device) - torch.gather(start, 1, se)
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, E * cap)          # E*cap: drop
    st = order // k                                             # token in group
    src = torch.gather(xg, 1, st[..., None].expand(G, Tg * k, D))
    buf = torch.zeros((G, E * cap + 1, D), dtype=xt.dtype, device=x.device)
    buf.scatter_(1, dest[..., None].expand(G, Tg * k, D), src)
    buf = buf[:, :E * cap].reshape(G, E, cap, D)

    # ---- expert compute ----------------------------------------------------
    h = torch.einsum("gecd,edf->gecf", buf, p["wi"])
    g_ = torch.einsum("gecd,edf->gecf", buf, p["wg"])
    h = F.silu(g_.float()).to(buf.dtype) * h
    del g_
    out = torch.einsum("gecf,efd->gecd", h, p["wo"]).reshape(G, E * cap, D)
    del h

    # ---- combine (group-local gather + weighted scatter-add) ----------------
    back = torch.gather(out, 1, torch.clamp(dest, max=E * cap - 1)[..., None]
                        .expand(G, Tg * k, D))
    sp = torch.gather(gp, 1, order)
    w = torch.where(keep, sp, 0.0).to(back.dtype)[..., None]
    rows = (st + torch.arange(G, device=x.device)[:, None] * Tg).reshape(-1)
    y = torch.zeros((G * Tg, D), dtype=back.dtype, device=x.device)
    y.index_add_(0, rows, (back * w * keep[..., None]).reshape(-1, D))
    y = y.reshape(B, S, D)

    # ---- shared experts (always-on, DeepSeek-style) --------------------------
    if "shared" in p:
        s = p["shared"]
        hs = xt @ s["wi"]
        gs = xt @ s["wg"]
        hs = F.silu(gs.float()).to(xt.dtype) * hs
        y = y + (hs @ s["wo"]).reshape(B, S, D)

    # ---- Switch aux load-balance loss ----------------------------------------
    f_e = torch.zeros(E, dtype=_F32, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(T * k, dtype=_F32, device=x.device))
    f_e = f_e / (T * k)
    P_e = probs.mean(0)
    aux = cfg.router_aux_coef * E * torch.sum(f_e * P_e)
    return y.to(x.dtype), aux
