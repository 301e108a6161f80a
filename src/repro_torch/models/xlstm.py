"""xLSTM blocks, ported from ``repro/models/xlstm.py``: mLSTM (matrix
memory) and sLSTM (scalar memory), arXiv:2405.04517.

Both use the stabilized exponential gating of the paper (running max m).
The plain recurrences ``mlstm_cell_ref`` / ``slstm_cell_ref`` are Python
loops over time. Without autograd they update the state in place (prefill,
decode, the captured ``slstm_scan``). Under autograd (grad enabled and an
input that requires grad: training) they run functional steps, the
reference's, through ``layers.chunked_scan``: the backward pass keeps the
(B, H, hd, hd) matrix memory (the sLSTM's four (B, H, hd) tensors) only
every 256 steps and recomputes each chunk, as the reference's
``chunked_scan`` does. A given state is then only read, and the new one
comes back as a new dict. ``mlstm_apply(impl="kernel")`` —
the JAX ``impl="pallas"`` — runs the recurrence through
``kernels.ops.mlstm``: the hand-written K7 kernel for CUDA tensors, the
plain recurrence on the CPU. The sLSTM recurrence has no kernel in the
reference either: there it is one compiled ``chunked_scan``, and here
``slstm_apply(impl="kernel")`` replays ``slstm_cell_ref`` as a captured
CUDA graph (``slstm_scan``, through ``core/graphs.py``), one graph per
device and shape shared by every sLSTM layer.

Decode: the state of one mLSTM layer is ``{"C", "n", "m"}``, of one sLSTM
layer ``{"c", "h", "m", "n"}``, all f32. Where JAX returns a new state,
``mlstm_decode`` / ``slstm_decode`` update the given one IN PLACE: the
gates are computed from the old ``m`` before anything is overwritten, then
C and n (c, n, h) are updated, and ``m`` last. ``pos`` is unused, as in
the reference.

On DTensors the mLSTM's ``d_inner`` stays over ``model`` (the
reference's hint) and both recurrences run on each rank's heads and
batch rows (``constrain.local_call``: DTensor has no rule for their
in-place steps or ``log_sigmoid``'s backward); a decode's state is
written back in its own placement.
"""
from __future__ import annotations

import gc

import torch
import torch.nn.functional as F

from repro_torch.core.graphs import GraphSet
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import _proj
from repro_torch.models.layers import (chunked_scan, needs_grad, trips,
                                       trunc_normal)
from repro_torch.sharding.constrain import constrain, local_call, on_mesh

IMPLS = ("ref", "kernel")
_F32 = torch.float32
_M_INIT = -1e30      # the initial stabilizer m of a decode state


def _zeros(shape, device):
    return torch.zeros(shape, dtype=_F32, device=device)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(gen, cfg, dtype, stack=()):
    d = cfg.d_model
    di = int(cfg.xlstm_proj_factor * d)
    H = cfg.n_heads
    hd = di // H
    return {
        "up": trunc_normal(gen, (*stack, d, 2 * di), d ** -0.5, dtype),
        "wq": trunc_normal(gen, (*stack, di, H, hd), di ** -0.5, dtype),
        "wk": trunc_normal(gen, (*stack, di, H, hd), di ** -0.5, dtype),
        "wv": trunc_normal(gen, (*stack, di, H, hd), di ** -0.5, dtype),
        "w_if": trunc_normal(gen, (*stack, di, H, 2), di ** -0.5, _F32),
        "b_if": _zeros((*stack, H, 2), gen.device),
        "gn_g": torch.ones((*stack, H, hd), dtype=dtype, device=gen.device),
        "down": trunc_normal(gen, (*stack, di, d), di ** -0.5, dtype),
    }


def _mlstm_step(carry, inp):
    """One step of the reference's recurrence, functional (a new carry)."""
    C, n, m = carry
    q_t, k_t, v_t, i_t, lf_t = inp                          # (B,H,...)
    lfm = lf_t + m
    m_new = torch.maximum(lfm, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(lfm - m_new)
    vk = v_t[..., :, None] * k_t[..., None, :]              # (B,H,hd,hd)
    C = C * f_p[..., None, None] + vk * i_p[..., None, None]
    n = n * f_p[..., None] + i_p[..., None] * k_t
    num = torch.matmul(C, q_t[..., None]).squeeze(-1)       # (B,H,hd)
    den = torch.maximum(torch.abs((n * q_t).sum(-1)), torch.exp(-m_new))
    return (C, n, m_new), num / den[..., None]


def mlstm_cell_ref(q, k, v, ig, fg, state=None):
    """Stabilized mLSTM recurrence, one time step after another.

    q,k,v: (B,S,H,hd); ig,fg: (B,S,H) raw gate pre-activations.
    state: dict(C:(B,H,hd,hd), n:(B,H,hd), m:(B,H)) f32, or None (C = n =
    0, m = -inf). Returns (h: (B,S,H,hd) f32, state). Without autograd the
    state is updated in place and returned; under autograd it is only read
    (the first step's ``f_p`` is ``exp(-inf) = 0``, whose gradient is 0)
    and the steps run through ``chunked_scan``, the new state a new dict.
    """
    B, S, H, hd = q.shape
    grad = needs_grad(q, k, v, ig, fg, *(state or {}).values())
    if state is None:
        state = {"C": _zeros((B, H, hd, hd), q.device),
                 "n": _zeros((B, H, hd), q.device),
                 "m": torch.full((B, H), float("-inf"), dtype=_F32,
                                 device=q.device)}
    C, n, m = state["C"], state["n"], state["m"]
    logf = F.logsigmoid(fg.float())
    igf = ig.float()
    qf, kf, vf = (t.float() * (hd ** -0.25) for t in (q, k, v))
    vf = vf * hd ** 0.25      # only q,k scaled (standard 1/sqrt(hd) split)
    if grad:
        (C, n, m), hs = chunked_scan(
            _mlstm_step, (C, n, m),
            tuple(t.transpose(0, 1) for t in (qf, kf, vf, igf, logf)))
        return hs.transpose(0, 1), {"C": C, "n": n, "m": m}
    hs = torch.empty((B, S, H, hd), dtype=_F32, device=q.device)
    for t in trips(S, q):
        lf_t, i_t, q_t, k_t = logf[:, t], igf[:, t], qf[:, t], kf[:, t]
        m_new = torch.maximum(lf_t + m, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(lf_t + m - m_new)
        vk = vf[:, t, :, :, None] * k_t[:, :, None, :]        # (B,H,hd,hd)
        C.mul_(f_p[..., None, None]).add_(vk.mul_(i_p[..., None, None]))
        n.mul_(f_p[..., None]).add_(i_p[..., None] * k_t)
        m.copy_(m_new)
        num = torch.matmul(C, q_t[..., None])[..., 0]          # (B,H,hd)
        den = torch.maximum(torch.abs((n * q_t).sum(-1)), torch.exp(-m_new))
        hs[:, t] = num / den[..., None]
    return hs, state


# local_call specs of the recurrences: heads over model, rows over the
# batch axes
_HEADS4, _HEADS3 = ("dp", None, "model", None), ("dp", None, "model")
_MSTATE = {"C": ("dp", "model", None, None), "n": ("dp", "model", None),
           "m": ("dp", "model")}
_MLSTM_IN = (_HEADS4, _HEADS4, _HEADS4, _HEADS3, _HEADS3)
_SSTATE = {k: ("dp", "model", None) for k in ("h", "c", "n", "m")}
_SLSTM_IN = (_HEADS4, ("model", None, None), ("model", None))


def _heads(x, w):
    """einsum('bsd,dhk->bshk'); on DTensors ``attention._proj``, each
    rank's rows and heads (DTensor's einsum cannot view a flat dim
    sharded 16 ways as xlstm-1.3b's 4 heads)."""
    if on_mesh(x, w):
        return _proj(x, w)
    return torch.einsum("bsd,dhk->bshk", x, w)


def _mlstm_qkvg(p, x, cfg):
    xz = constrain(x @ p["up"], (None, None, "model"))  # d_inner over model
    xm, z = torch.chunk(xz, 2, dim=-1)
    q, k, v = (_heads(xm, p[n]) for n in ("wq", "wk", "wv"))
    g = _heads(xm.float(), p["w_if"]) + p["b_if"]
    return q, k, v, g[..., 0], g[..., 1], z


def _mlstm_out(p, h, z, x_dtype, eps):
    hf = h.float()
    var = torch.mean(hf * hf, dim=-1, keepdim=True)        # per-head groupnorm
    hn = (hf * torch.rsqrt(var + eps)) * p["gn_g"].float()
    hn = hn.reshape(*h.shape[:-2], -1)
    y = hn * F.silu(z.float())
    return y.to(x_dtype) @ p["down"]


def mlstm_apply(p, x, cfg, impl="ref"):
    """x: (B,S,D) -> (B,S,D). ``impl="kernel"`` runs the recurrence
    through ``kernels.ops.mlstm`` (K7 on the card), ``"ref"`` through
    ``mlstm_cell_ref``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    q, k, v, ig, fg, z = _mlstm_qkvg(p, x, cfg)
    if impl == "kernel":
        h, _ = kops.mlstm(*(t.contiguous() for t in (q, k, v, ig, fg)))
    else:
        h, _ = local_call(mlstm_cell_ref, (q, k, v, ig, fg), _MLSTM_IN,
                          (_HEADS4, _MSTATE))
    return _mlstm_out(p, h, z, x.dtype, cfg.norm_eps)


def _empty(shape, device):
    return torch.empty(shape, dtype=_F32, device=device)


def mlstm_state_init(cfg, batch, dtype, device, stack=()):
    """C = n = 0 and m = -1e30 (as the reference and the TPU kernel start),
    with a leading ``stack`` dim. The state is f32 whatever ``dtype``, as
    in the reference."""
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    H, hd = cfg.n_heads, di // cfg.n_heads
    return mlstm_state_reset_({"C": _empty((*stack, batch, H, hd, hd), device),
                               "n": _empty((*stack, batch, H, hd), device),
                               "m": _empty((*stack, batch, H), device)})


def mlstm_state_reset_(state):
    """Write ``mlstm_state_init``'s values into ``state`` in place."""
    state["C"].zero_()
    state["n"].zero_()
    state["m"].fill_(_M_INIT)
    return state


def mlstm_decode(p, x, cfg, state, pos):
    """x: (B,1,D); ``state`` is updated in place. Returns (y, state)."""
    q, k, v, ig, fg, z = _mlstm_qkvg(p, x, cfg)
    h, _ = local_call(mlstm_cell_ref, (q, k, v, ig, fg, state),
                      _MLSTM_IN + (_MSTATE,), (_HEADS4, False), inplace=(5,))
    return _mlstm_out(p, h, z, x.dtype, cfg.norm_eps), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_init(gen, cfg, dtype, stack=()):
    d = cfg.d_model
    H = cfg.n_heads
    hd = d // H
    f = int(cfg.slstm_proj_factor * d)
    return {
        "w_in": trunc_normal(gen, (*stack, d, H, 4 * hd), d ** -0.5, dtype),
        # block-diagonal hidden-to-hidden recurrence, per head
        "r": trunc_normal(gen, (*stack, H, hd, 4 * hd), hd ** -0.5, _F32),
        "b": _zeros((*stack, H, 4 * hd), gen.device),
        "gn_g": torch.ones((*stack, H, hd), dtype=dtype, device=gen.device),
        "up1": trunc_normal(gen, (*stack, d, f), d ** -0.5, dtype),
        "up2": trunc_normal(gen, (*stack, d, f), d ** -0.5, dtype),
        "down": trunc_normal(gen, (*stack, f, d), f ** -0.5, dtype),
    }


def _slstm_step(r, b):
    """The reference's step for recurrence ``r`` and bias ``b``,
    functional (a new carry)."""
    def step(carry, wx_t):
        h, c, n, m = carry
        pre = wx_t + torch.einsum("bhk,hkg->bhg", h, r) + b    # (B,H,4hd)
        zt, it, ft, ot = torch.chunk(pre, 4, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        lf = F.logsigmoid(ft)
        lfm = lf + m
        m_new = torch.maximum(lfm, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lfm - m_new)
        c = c * f_p + i_p * zt
        n = n * f_p + i_p
        h = ot * c / torch.clamp(n, min=1e-6)
        return (h, c, n, m_new), h
    return step


def slstm_cell_ref(wx, r, b, state):
    """wx: (B,S,H,4*hd) input contributions; recurrence per head.

    state: dict(h,c,n,m: (B,H,hd)) f32. Returns (h_seq (B,S,H,hd) f32,
    state). Without autograd the state is updated in place and returned;
    under autograd it is only read and the steps run through
    ``chunked_scan``, the new state a new dict."""
    h, c, n, m = state["h"], state["c"], state["n"], state["m"]
    wxf = wx.float()
    if needs_grad(wx, r, b, h, c, n, m):
        (h, c, n, m), hs = chunked_scan(_slstm_step(r, b), (h, c, n, m),
                                        wxf.transpose(0, 1))
        return hs.transpose(0, 1), {"h": h, "c": c, "n": n, "m": m}
    hs = torch.empty((*wx.shape[:3], r.shape[-2]), dtype=_F32,
                     device=wx.device)
    for t in trips(wx.shape[1], wx):
        pre = wxf[:, t] + torch.einsum("bhk,hkg->bhg", h, r) + b   # (B,H,4hd)
        zt, it, ft, ot = torch.chunk(pre, 4, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        lf = F.logsigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(lf + m - m_new)
        c.mul_(f_p).add_(i_p * zt)
        n.mul_(f_p).add_(i_p)
        m.copy_(m_new)
        h.copy_(ot * c / torch.clamp(n, min=1e-6))
        hs[:, t] = h
    return hs, state


def _slstm_state(shape, device):
    return slstm_state_reset_({k: _empty(shape, device)
                               for k in ("h", "c", "n", "m")})


def slstm_state_init(cfg, batch, dtype, device, stack=()):
    """h = c = n = 0 (three tensors: each is updated in place) and
    m = -1e30; f32 whatever ``dtype``, as in the reference."""
    return _slstm_state((*stack, batch, cfg.n_heads,
                         cfg.d_model // cfg.n_heads), device)


def slstm_state_reset_(state):
    """Write ``slstm_state_init``'s values into ``state`` in place."""
    for k in ("h", "c", "n"):
        state[k].zero_()
    state["m"].fill_(_M_INIT)
    return state


# The captured recurrence: one GraphSet per device, one graph per layout
# of (wx, r, b), which are copied into the graph's own static inputs, so
# every sLSTM layer of a model shares one graph per (B, S).
_SLSTM_GRAPHS = {}


def _slstm_scan(wx, r, b):
    B, _, H, _ = wx.shape
    return slstm_cell_ref(wx, r, b, _slstm_state((B, H, r.shape[-2]),
                                                 wx.device))


def slstm_scan(wx, r, b):
    """``slstm_cell_ref`` from ``slstm_state_init``'s state, as a replay of
    a captured graph on the card (the port of the reference's compiled
    ``chunked_scan``), uncaptured on the CPU. Forward only. Returns the
    graph's static ``(hs, state)``, which the next call for the same
    shape overwrites: consume them first (stream order covers work
    enqueued before that call)."""
    if needs_grad(wx, r, b):
        raise RuntimeError(
            "slstm_scan is forward only (a captured graph has no backward "
            "pass); train through slstm_cell_ref (impl='ref')")
    step = _SLSTM_GRAPHS.get(wx.device)
    if step is None:
        step = GraphSet(wx.device).capture(
            _slstm_scan, "sLSTM recurrence", inputs=(0, 1, 2),
            own_inputs=True)
        _SLSTM_GRAPHS[wx.device] = step
    return step(wx, r, b)


def slstm_graph_counts():
    """Captures and replays of ``slstm_scan``, summed over devices (on the
    CPU ``captures`` counts the shapes first run and nothing replays)."""
    steps = list(_SLSTM_GRAPHS.values())
    return {"captures": sum(s.captures for s in steps),
            "replays": sum(s.replays for s in steps)}


def release_slstm_graphs():
    """Drop ``slstm_scan``'s graphs, their pools and static inputs."""
    _SLSTM_GRAPHS.clear()
    gc.collect()            # a GraphSet and its functions form a cycle


def _slstm_out(p, h, x, cfg):
    hf = h.float()
    var = torch.mean(hf * hf, dim=-1, keepdim=True)
    hn = (hf * torch.rsqrt(var + cfg.norm_eps)) * p["gn_g"].float()
    hn = hn.reshape(*h.shape[:-2], -1).to(x.dtype)
    a = hn @ p["up1"]
    g = hn @ p["up2"]
    # jax.nn.gelu is the tanh approximation by default
    a = a * F.gelu(g.float(), approximate="tanh").to(x.dtype)
    return a @ p["down"]


def slstm_apply(p, x, cfg, impl="ref"):
    """x: (B,S,D) -> (B,S,D). ``impl="kernel"`` runs the recurrence
    through ``slstm_scan`` (a captured graph on the card; no kernel covers
    it, in the reference either) unless a capture is already running;
    ``"ref"`` through ``slstm_cell_ref``."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}; got {impl!r}")
    wx = _heads(x, p["w_in"])
    if impl == "kernel" and not (
            wx.is_cuda and torch.cuda.is_current_stream_capturing()):
        h, _ = slstm_scan(wx, p["r"], p["b"])
    else:
        h, _ = local_call(_slstm_scan, (wx, p["r"], p["b"]), _SLSTM_IN,
                          (_HEADS4, _SSTATE))
    return _slstm_out(p, h, x, cfg)


def slstm_decode(p, x, cfg, state, pos):
    """x: (B,1,D); ``state`` is updated in place. Returns (y, state)."""
    wx = _heads(x, p["w_in"])
    h, _ = local_call(slstm_cell_ref, (wx, p["r"], p["b"], state),
                      _SLSTM_IN + (_SSTATE,), (_HEADS4, False), inplace=(3,))
    return _slstm_out(p, h, x, cfg), state
