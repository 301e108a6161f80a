"""Model assembly, ported from ``repro/models/transformer.py``.

A config's ``segments`` is a sequence of (pattern, repeats); each pattern
entry is "<mixer>:<ffn>". Parameters for each pattern position carry a
leading ``repeats`` dim, as in the JAX tree, and ``forward`` loops over
it. The port runs ``gqa:dense``, ``mamba:dense``, ``mamba:moe``,
``mlstm:-`` and ``slstm:-`` layers; ``layer_apply`` returns the layer's
MoE aux loss beside its output and ``forward`` sums it over the layers.
The other mixers and FFNs (MLA, Arctic's ``moe_dense``), the
multi-token-prediction head and the prefix input mode are still to port
(ROADMAP.md).

Serving: ``prefill`` is the full-sequence forward with the LM head on the
last position only (``impl="kernel"`` runs attention through K5, the
Mamba scan through K6 and the mLSTM recurrence through K7);
``init_cache`` / ``decode_step`` run one token against a per-layer cache:
a KV cache for attention, the conv tail and SSM state for Mamba, the
recurrent state for xLSTM. The cache is a list of segments, each
``{"p<j>": ...}`` with a leading ``repeats`` dim as in the JAX tree,
allocated for real (JAX broadcasts one layer's zeros) because
``decode_step`` updates it in place; ``reset_cache_`` gives it back its
initial values in place.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (dense_init, embed_apply, embed_init,
                                       ffn_apply, ffn_init, lm_head_apply,
                                       rmsnorm_apply, rmsnorm_init,
                                       softmax_xent)
from repro_torch.tree import leaves, tree_map

PORTED_KINDS = ("gqa:dense", "mamba:dense", "mamba:moe", "mlstm:-",
                "slstm:-")
_MIXER_INIT = {"gqa": attn.attn_init, "mamba": mam.mamba_init,
               "mlstm": xl.mlstm_init, "slstm": xl.slstm_init}
_MIXER_DECODE = {"gqa": attn.attn_decode, "mamba": mam.mamba_decode,
                 "mlstm": xl.mlstm_decode, "slstm": xl.slstm_decode}
_MIXER_CACHE_RESET = {"gqa": attn.attn_cache_reset_,
                      "mamba": mam.mamba_state_reset_,
                      "mlstm": xl.mlstm_state_reset_,
                      "slstm": xl.slstm_state_reset_}


def _check_kind(kind):
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} not yet ported, see ROADMAP.md "
            f"(ported: {PORTED_KINDS})")


def _check_supported(cfg):
    for pattern, _ in cfg.segments:
        for kind in pattern:
            _check_kind(kind)
    if cfg.mtp_depth:
        raise NotImplementedError(
            "multi-token prediction not yet ported, see ROADMAP.md")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input_mode {cfg.input_mode!r} not yet ported, see ROADMAP.md")


def layer_init(gen, kind, cfg, dtype, stack=()):
    mixer, ffn = kind.split(":")
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, stack, gen.device)}
    p["mixer"] = _MIXER_INIT[mixer](gen, cfg, dtype, stack)
    if ffn != "-":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, stack, gen.device)
        p["ffn"] = (ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, stack)
                    if ffn == "dense" else
                    moe_mod.moe_init(gen, cfg, dtype, stack))
    return p


def _ffn_residual(p, kind, x, cfg):
    """The FFN half of a layer -> (x, the MoE aux loss or None)."""
    ffn = kind.split(":")[1]
    aux = None
    if ffn != "-":
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        if ffn == "dense":
            y = ffn_apply(p["ffn"], h)
        else:
            y, aux = moe_mod.moe_apply(p["ffn"], h, cfg)
        x = x + y
    return x, aux


def layer_apply(p, kind, x, cfg, positions, impl="ref"):
    """One layer over a whole sequence -> (x, aux loss)."""
    mixer = kind.split(":")[0]
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    if mixer == "gqa":
        y, _ = attn.attn_apply(p["mixer"], h, cfg, positions, impl)
    elif mixer == "mamba":
        y = mam.mamba_apply(p["mixer"], h, cfg, impl)
    elif mixer == "mlstm":
        y = xl.mlstm_apply(p["mixer"], h, cfg, impl)
    else:
        y = xl.slstm_apply(p["mixer"], h, cfg, impl)
    x, aux = _ffn_residual(p, kind, x + y, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def layer_cache_init(kind, cfg, batch, seq_len, dtype, device, stack=()):
    _check_kind(kind)
    mixer = kind.split(":")[0]
    if mixer == "gqa":
        return attn.attn_cache_init(cfg, batch, seq_len, dtype, device,
                                    stack)
    if mixer == "mamba":
        return mam.mamba_state_init(cfg, batch, dtype, device, stack)
    if mixer == "mlstm":
        return xl.mlstm_state_init(cfg, batch, dtype, device, stack)
    return xl.slstm_state_init(cfg, batch, dtype, device, stack)


def layer_decode(p, kind, x, cfg, cache, pos):
    """One token through one layer; ``cache`` is updated in place. The
    MoE aux loss is dropped, as in the reference."""
    _check_kind(kind)
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    y, cache = _MIXER_DECODE[kind.split(":")[0]](p["mixer"], h, cfg, cache,
                                                 pos)
    x, _ = _ffn_residual(p, kind, x + y, cfg)
    return x, cache


def init_params(seed, cfg, dtype=torch.bfloat16, device=None):
    """Random params with the JAX tree's keys, nesting and shapes.

    ``seed`` is an int or a ``torch.Generator`` (whose device must then be
    ``device``). The numbers differ from ``jax.random``'s for the same
    seed; tests that compare the packages initialise in JAX and carry the
    params across with ``checkpoint.io.params_from_numpy``."""
    dev = resolve_device(device)
    _check_supported(cfg)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
              "final_norm": rmsnorm_init(cfg.d_model, dtype, (), dev),
              "segments": []}
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    for pattern, repeats in cfg.segments:
        params["segments"].append(
            {f"p{j}": layer_init(gen, kind, cfg, dtype, stack=(repeats,))
             for j, kind in enumerate(pattern)})
    return params


def forward(params, cfg, batch, impl="ref", return_hidden=False,
            apply_head=True):
    """Returns (logits, aux_loss[, hidden]); ``logits`` is None when
    ``apply_head`` is False; ``aux_loss`` sums the MoE layers' Switch
    losses (0 without MoE). Every layer's activations are kept for the
    backward pass: the per-layer recomputation of the JAX package
    (``remat``) is not ported yet (ROADMAP.md)."""
    _check_supported(cfg)
    x = embed_apply(params["embed"], batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg_params, (pattern, repeats) in zip(params["segments"],
                                              cfg.segments):
        for r in range(repeats):
            for j, kind in enumerate(pattern):
                p_r = tree_map(lambda t, _r=r: t[_r], seg_params[f"p{j}"])
                x, a = layer_apply(p_r, kind, x, cfg, positions, impl)
                aux = aux + a
    h = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = None
    if apply_head:
        logits = lm_head_apply(params["embed"], params.get("head"), h,
                               cfg.tie_embeddings)
    if return_hidden:
        return logits, aux, h
    return logits, aux


def loss_fn(params, cfg, batch, impl="ref"):
    """Next-token LM loss. labels: -1 = ignore. Returns (loss, metrics)."""
    logits, aux = forward(params, cfg, batch, impl)
    loss = softmax_xent(logits, batch["labels"])
    total = loss + aux
    return total, {"lm_loss": loss, "aux_loss": aux, "loss": total}


# ---------------------------------------------------------------------------
# Serving: prefill and one-token decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch, seq_len, dtype=torch.bfloat16, device=None):
    """Per pattern position of every segment, with a leading ``repeats``
    dim: a zero ``(repeats, B, S, KV, hd)`` k/v pair for attention, the
    conv tail and f32 SSM state (``mamba.mamba_state_init``) for Mamba,
    the f32 recurrent state (``xlstm.*_state_init``) for xLSTM."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [{f"p{j}": layer_cache_init(kind, cfg, batch, seq_len, dtype,
                                       dev, stack=(repeats,))
             for j, kind in enumerate(pattern)}
            for pattern, repeats in cfg.segments]


def reset_cache_(cfg, cache):
    """Write ``init_cache``'s values into ``cache`` in place (each mixer's
    reset beside its init keeps them in one place) and return it: a
    serving loop reuses one cache, and a captured decode step the storage
    it was captured on. The reference has no counterpart, as it rebuilds
    the cache as a value."""
    for seg_cache, (pattern, _) in zip(cache, cfg.segments):
        for j, kind in enumerate(pattern):
            _check_kind(kind)
            _MIXER_CACHE_RESET[kind.split(":")[0]](seg_cache[f"p{j}"])
    return cache


@torch.no_grad()
def decode_step(params, cfg, cache, token, pos):
    """token: (B,1) int; pos: 0-d int tensor on the model's device.
    Returns (logits (B,1,V), cache), the cache updated in place."""
    x = embed_apply(params["embed"], token)
    for seg_params, seg_cache, (pattern, repeats) in zip(
            params["segments"], cache, cfg.segments):
        for r in range(repeats):
            for j, kind in enumerate(pattern):
                p_r = tree_map(lambda t, _r=r: t[_r], seg_params[f"p{j}"])
                c_r = tree_map(lambda t, _r=r: t[_r], seg_cache[f"p{j}"])
                x, _ = layer_decode(p_r, kind, x, cfg, c_r, pos)
    h = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head_apply(params["embed"], params.get("head"), h,
                           cfg.tie_embeddings)
    return logits, cache


@torch.no_grad()
def prefill(params, cfg, batch, impl="ref"):
    """Full-sequence forward -> last-position logits (B, V). The LM head
    is applied to the last position only, as in the JAX package: the
    whole (B, S, V) logits would dominate a long prefill."""
    _, _, h = forward(params, cfg, batch, impl, return_hidden=True,
                      apply_head=False)
    logits = lm_head_apply(params["embed"], params.get("head"), h[:, -1:],
                           cfg.tie_embeddings)
    return logits[:, 0]


def count_params(params):
    return sum(t.numel() for t in leaves(params))
