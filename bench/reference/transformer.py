"""Plain PyTorch reference of the decoder LMs of the ``transformer`` family
(GQA attention, Mamba, dense SwiGLU and top-k MoE FFNs, any interleave),
written from the published descriptions and independent of the program.

It imports nothing of the port. It reads a params tree in the port's
nesting (which the benchmark drew itself, ``bench/weights.py``):
``embed.table (V, d)``, ``final_norm.g``, ``head.w (d, V)`` and
``segments[i]["p<j>"]``, each leaf with a leading ``repeats`` dim, for the
layer kinds ``"<mixer>:<ffn>"`` of ``arch["segments"]``. ``arch`` is the
configuration file's ``model`` dict.

The mathematics, as the configurations state it:

* pre-norm residual layers, RMSNorm ``x * rsqrt(mean(x^2) + eps) * g``;
* attention: q, k, v projections, rotary embedding over halves (theta
  ``rope_theta``, positions from 0), q scaled by ``hd**-0.5``, causal
  softmax, kv head ``h // (H / KV)`` serving query head ``h``;
* SwiGLU: ``(silu(x wg) * (x wi)) wo``;
* MoE: f32 router softmax, top-k, the k weights renormalised; tokens in
  groups (the largest power of two <= 64 that divides the tokens and
  leaves each group >= 4 E tokens), each expert taking at most
  ``capacity`` of a group's picks in token order (``int(cf * Tg * k / E)``
  rounded up to a multiple of 4, at least 4); a dropped pick adds nothing;
* Mamba: in-projection to (x, z), depthwise causal conv (kernel K) + bias,
  silu, x-projection to (dt, B, C), ``dt = softplus(dt W + b)``, the
  selective scan ``h = h * exp(dt A) + dt B x``, ``y = h C + D x``, gated by
  ``silu(z)``, out-projection; ``A = -exp(A_log)``;
* the LM loss: mean next-token cross entropy over the labels.

``low=True`` is the control: every product of two tensors runs on
operands rounded to TF32 (10 explicit mantissa bits, round to nearest),
forward and backward, as an f32 model would if TF32 were switched on.
The scan's elementwise recurrence stays f32, as no tensor core runs it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# weights: how each leaf of the tree is drawn
# ---------------------------------------------------------------------------
def init_rule(path, shape):
    """``(kind, arg)`` for the leaf at ``path`` (``a/b/c``): norms and
    Mamba's D are ones, biases zero, dt's bias -4.6 (softplus^-1 of 0.01),
    Mamba's A_log ``log(1..state)``; every weight a normal scaled by its
    fan-in's -1/2 power."""
    name = path.rsplit("/", 1)[-1]
    parent = path.rsplit("/", 2)[-2] if path.count("/") else ""
    if name in ("g", "D"):
        return "const", 1.0
    if name == "A_log":
        return "arange_log", None
    if name == "b":
        return "const", -4.6 if parent == "dt_proj" else 0.0
    if name in ("conv_b", "bq", "bk", "bv"):
        return "const", 0.0
    if name == "table":
        fan = shape[-1]
    elif name in ("wq", "wk", "wv") and parent == "mixer":
        fan = shape[-3]
    elif name == "wo" and parent == "mixer":
        fan = shape[-3] * shape[-2]
    else:
        fan = shape[-2]
    return "normal", fan ** -0.5


# ---------------------------------------------------------------------------
# products, at f32 or (the control) on TF32 operands
# ---------------------------------------------------------------------------
def tf32(x):
    """``x`` (f32) rounded to TF32: 13 low mantissa bits dropped, to
    nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2 ** 31, dtype=torch.int32, device=x.device)
    mag = bits & 0x7FFFFFFF
    mag = (mag + 0xFFF + ((mag >> 13) & 1)) & ~0x1FFF
    return (mag | sign).view(torch.float32)


class _LowMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32(a) @ tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        ga = g @ tf32(b).transpose(-1, -2)
        gb = tf32(a).transpose(-1, -2) @ g
        # broadcast batch dims back to the operands' shapes
        while ga.ndim > a.ndim:
            ga = ga.sum(0)
        while gb.ndim > b.ndim:
            gb = gb.sum(0)
        return ga, gb


def mm(a, b, low):
    return _LowMatmul.apply(a, b) if low else a @ b


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def rmsnorm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * g


def rope(x, theta):
    """x: (B, S, H, hd), positions 0..S-1; rotation over the two halves."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p, x, arch, low):
    B, S, d = x.shape
    H, KV, hd = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    q = mm(x, p["wq"].reshape(d, H * hd), low).view(B, S, H, hd)
    k = mm(x, p["wk"].reshape(d, KV * hd), low).view(B, S, KV, hd)
    v = mm(x, p["wv"].reshape(d, KV * hd), low).view(B, S, KV, hd)
    q, k = rope(q, arch["rope_theta"]), rope(k, arch["rope_theta"])
    G = H // KV
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    outs = []
    for b in range(B):                  # one row's scores at a time
        qb = (q[b] * hd ** -0.5).transpose(0, 1)          # (H, S, hd)
        kb, vb = k[b].transpose(0, 1), v[b].transpose(0, 1)
        s = mm(qb, kb.transpose(-1, -2), low)
        s = s.masked_fill(~causal, float("-inf"))
        outs.append(mm(torch.softmax(s, -1), vb, low).transpose(0, 1))
    out = torch.stack(outs).reshape(B, S, H * hd)
    return mm(out, p["wo"].reshape(H * hd, d), low)


def swiglu(x, wi, wg, wo, low):
    return mm(F.silu(mm(x, wg, low)) * mm(x, wi, low), wo, low)


def moe_groups(T, E):
    g = 1
    while g < 64 and T % (2 * g) == 0 and T // (2 * g) >= 4 * E:
        g *= 2
    return g


def moe_capacity(Tg, arch):
    c = int(arch["capacity_factor"] * Tg * arch["top_k"] / arch["n_experts"])
    return max(4, -(-c // 4) * 4)


def route(p, xt, arch, low):
    """(router probabilities (T, E), the top-k weights renormalised (T, k),
    the top-k experts (T, k)) of tokens ``xt`` (T, d)."""
    probs = torch.softmax(mm(xt, p["router"], low), -1)
    top_p, top_i = torch.topk(probs, arch["top_k"], dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, top_p, top_i


def capacity_keep(top_i, arch):
    """(T, k) bool: which picks their expert takes within its group's
    capacity, in token order."""
    T, k = top_i.shape
    E = arch["n_experts"]
    G = moe_groups(T, E)
    Tg = T // G
    cap = moe_capacity(Tg, arch)
    picks = top_i.reshape(G, Tg * k)                     # token order
    onehot = F.one_hot(picks, E)
    rank = (onehot.cumsum(1) - 1).gather(2, picks[..., None])[..., 0]
    return (rank < cap).reshape(T, k)


def moe(p, x, arch, low):
    B, S, d = x.shape
    T, E = B * S, arch["n_experts"]
    xt = x.reshape(T, d)
    probs, top_p, top_i = route(p, xt, arch, low)
    keep = capacity_keep(top_i, arch)
    y = torch.zeros_like(xt)
    for e in range(E):
        tok, slot = torch.nonzero((top_i == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(xt[tok], p["wi"][e], p["wg"][e], p["wo"][e], low)
        y = y.index_add(0, tok, out * top_p[tok, slot][:, None])
    # the Switch load-balance loss: E * sum_e (share of picks) * (mean prob)
    f_e = torch.bincount(top_i.reshape(-1), minlength=E).float() / top_i.numel()
    aux = arch["router_aux_coef"] * E * (f_e * probs.mean(0)).sum()
    return y.reshape(B, S, d), aux


def mamba(p, x, arch, low):
    B, S, d = x.shape
    di = arch["ssm_expand"] * d
    st, K = arch["ssm_state_dim"], arch["ssm_conv_dim"]
    dtr = arch["ssm_dt_rank"]
    xz = mm(x, p["in_proj"], low)
    xi, z = xz[..., :di], xz[..., di:]
    xp = F.pad(xi, (0, 0, K - 1, 0))
    xc = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(K)) + p["conv_b"]
    xc = F.silu(xc)
    proj = mm(xc, p["x_proj"], low)
    dt = F.softplus(mm(proj[..., :dtr], p["dt_proj"]["w"], low)
                    + p["dt_proj"]["b"])
    Bm, Cm = proj[..., dtr:dtr + st], proj[..., dtr + st:]
    A = -torch.exp(p["A_log"])                               # (di, st)
    h = torch.zeros(B, di, st, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dt[:, t, :, None]
        h = h * torch.exp(dtt * A) + dtt * Bm[:, t, None, :] * \
            xc[:, t, :, None]
        ys.append((h * Cm[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) + xc * p["D"]
    return mm(y * F.silu(z), p["out_proj"], low)


def layer_kinds(arch):
    return [(i, j, kind) for i, (pattern, repeats) in
            enumerate(arch["segments"]) for _ in range(repeats)
            for j, kind in enumerate(pattern)]


def hidden(params, arch, tokens, low=False):
    """(the final-normed hidden states (B, S, d) of ``tokens`` (B, S), the
    MoE layers' summed load-balance loss)."""
    eps = arch["norm_eps"]
    x = params["embed"]["table"][tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    seen = {}
    for i, j, kind in layer_kinds(arch):
        r = seen.get((i, j), 0)
        seen[(i, j)] = r + 1
        p = {k: _slice(v, r) for k, v in
             params["segments"][i][f"p{j}"].items()}
        mixer, ffn = kind.split(":")
        h = rmsnorm(x, p["norm1"]["g"], eps)
        if mixer == "gqa":
            x = x + attention(p["mixer"], h, arch, low)
        elif mixer == "mamba":
            x = x + mamba(p["mixer"], h, arch, low)
        else:
            raise ValueError(f"no reference for mixer {mixer!r}")
        if ffn != "-":
            h = rmsnorm(x, p["norm2"]["g"], eps)
            f = p["ffn"]
            if ffn == "dense":
                x = x + swiglu(h, f["wi"], f["wg"], f["wo"], low)
            elif ffn == "moe":
                y, a = moe(f, h, arch, low)
                x, aux = x + y, aux + a
            else:
                raise ValueError(f"no reference for ffn {ffn!r}")
    return rmsnorm(x, params["final_norm"]["g"], eps), aux


def _slice(tree, r):
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return tree[r]


def _head(params, arch, h, low):
    w = (params["embed"]["table"].t() if arch.get("tie_embeddings")
         else params["head"]["w"])
    return mm(h, w, low)


def logits(params, arch, tokens, low=False, last_only=False):
    """(B, S, V) logits, or (B, V) of the last position."""
    h, _ = hidden(params, arch, tokens, low)
    return _head(params, arch, h[:, -1] if last_only else h, low)


def loss(params, arch, tokens, labels, low=False):
    """Mean next-token cross entropy over every label, plus the MoE
    layers' load-balance loss (0-d)."""
    h, aux = hidden(params, arch, tokens, low)
    lg = _head(params, arch, h, low)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.reshape(-1)) + aux
