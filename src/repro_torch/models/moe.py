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
leaves them to XLA; the sharding hints are ``constrain`` at the
reference's four sites. Spans (``repro_torch.spans``): ``rt.moe.route``
(the router and the dispatch), ``rt.moe.experts`` (the expert products),
``rt.moe.combine``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.models.layers import trunc_normal
from repro_torch.sharding.constrain import constrain, dp_size, local_call

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


def _dispatch(xg, ge, E, cap, k):
    """One group's sort-based dispatch, over every group of ``ge`` (G,
    Tg*k expert ids) -> (buf (G,E,cap,D), order, dest, keep)."""
    G, n = ge.shape
    D = xg.shape[-1]
    order = torch.argsort(ge, dim=1, stable=True)
    se = torch.gather(ge, 1, order)                             # sorted ids
    experts = torch.arange(E, device=ge.device).expand(G, E).contiguous()
    start = torch.searchsorted(se, experts)                     # (G,E)
    rank = torch.arange(n, device=ge.device) - torch.gather(start, 1, se)
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, E * cap)          # E*cap: drop
    st = order // k                                             # token in group
    src = torch.gather(xg, 1, st[..., None].expand(G, n, D))
    buf = torch.zeros((G, E * cap + 1, D), dtype=xg.dtype, device=xg.device)
    buf.scatter_(1, dest[..., None].expand(G, n, D), src)
    return buf[:, :E * cap].reshape(G, E, cap, D), order, dest, keep


def _combine(out, gp, order, dest, keep, k):
    """Group-local gather + weighted scatter-add -> (G, Tg, D)."""
    G, n_slots, D = out.shape
    n = dest.shape[1]
    Tg = n // k
    back = torch.gather(out, 1, torch.clamp(dest, max=n_slots - 1)[..., None]
                        .expand(G, n, D))
    sp = torch.gather(gp, 1, order)
    w = torch.where(keep, sp, 0.0).to(back.dtype)[..., None]
    st = order // k
    rows = (st + torch.arange(G, device=out.device)[:, None] * Tg).reshape(-1)
    y = torch.zeros((G * Tg, D), dtype=back.dtype, device=out.device)
    y.index_add_(0, rows, (back * w * keep[..., None]).reshape(-1, D))
    return y.reshape(G, Tg, D)


def _expert_up(buf, wi, wg):
    h = torch.einsum("gecd,edf->gecf", buf, wi)
    g_ = torch.einsum("gecd,edf->gecf", buf, wg)
    return F.silu(g_.float()).to(buf.dtype) * h


def _expert_down(h, wo):
    return torch.einsum("gecf,efd->gecd", h, wo)


def _expert_counts(top_i, E):
    """f_e of the Switch loss: each expert's share of the T*k picks."""
    n = top_i.numel()
    return torch.zeros(E, dtype=_F32, device=top_i.device).index_add_(
        0, top_i.reshape(-1), torch.ones(n, dtype=_F32,
                                          device=top_i.device)) / n


def moe_apply(p, x, cfg):
    """x: (B,S,D) -> (y (B,S,D) in x's dtype, aux_loss f32 0-d).

    On DTensors the groups ride the batch axes ("dp") and the experts
    ``model``, as the reference's hints place them; the dispatch, the
    combine and the expert counts (argsort, searchsorted, scatter,
    index_add, which DTensor has no rule for) run on each group shard's
    local tensors (``constrain.local_call``), and so do the expert
    products (DTensor's einsum cannot view an expert-sharded operand as a
    batched matmul): each rank runs its experts on its groups, the expert
    weights gathered over ``data`` (FSDP)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)

    with spans.span("rt.moe.route"):
        logits = xt.float() @ p["router"]
        probs = torch.softmax(logits, dim=-1)                   # (T,E)
        top_p, top_i = torch.topk(probs, k, dim=-1)             # (T,k)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

        # ---- grouped sort-based dispatch -----------------------------------
        G = n_groups(T, E)
        Tg = T // G
        cap = capacity(Tg, cfg)
        if G % dp_size(xt):
            # fewer groups than the batch axes hold row shards (a decode
            # step's few tokens): DTensor cannot cut sharded rows into them
            xt, top_i, top_p = (constrain(t, ("r", None))
                                for t in (xt, top_i, top_p))
        xg = constrain(xt.reshape(G, Tg, D), ("dp", None, None))
        ge = top_i.reshape(G, Tg * k)                           # expert ids
        gp = top_p.reshape(G, Tg * k)
        grp, grp4 = ("dp", None), ("dp", None, None, None)
        buf, order, dest, keep = local_call(
            lambda a, b: _dispatch(a, b, E, cap, k), (xg, ge),
            (("dp", None, None), grp), (grp4, grp, grp, grp))
        buf = constrain(buf, ("dp", "model", None, None))

    # ---- expert compute (G on the batch axes, E on model) -------------------
    with spans.span("rt.moe.experts"):
        grp_e, per_e = ("dp", "model", None, None), ("model", None, None)
        h = local_call(_expert_up, (buf, p["wi"], p["wg"]),
                       (grp_e, per_e, per_e), grp_e)
        del buf
        h = constrain(h, grp_e)
        out = local_call(_expert_down, (h, p["wo"]), (grp_e, per_e), grp_e)
        del h
        # gather experts per group (before E and cap merge: a DTensor view
        # cannot merge a sharded dim)
        out = constrain(out, ("dp", "r", None, None)).reshape(G, E * cap, D)

    # ---- combine (group-local gather + weighted scatter-add) ----------------
    with spans.span("rt.moe.combine"):
        y = local_call(lambda *a: _combine(*a, k),
                       (out, gp, order, dest, keep),
                       (("dp", None, None), grp, grp, grp, grp),
                       ("dp", None, None)).reshape(B, S, D)

    # ---- shared experts (always-on, DeepSeek-style) --------------------------
    if "shared" in p:
        s = p["shared"]
        hs = xt @ s["wi"]
        gs = xt @ s["wg"]
        hs = F.silu(gs.float()).to(xt.dtype) * hs
        y = y + (hs @ s["wo"]).reshape(B, S, D)

    # ---- Switch aux load-balance loss ----------------------------------------
    f_e = local_call(lambda t: _expert_counts(t, E), (top_i,), ((None, None),),
                     (None,))
    P_e = probs.mean(0)
    aux = cfg.router_aux_coef * E * torch.sum(f_e * P_e)
    return y.to(x.dtype), aux
