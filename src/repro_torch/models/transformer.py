"""Model assembly, ported from ``repro/models/transformer.py``.

A config's ``segments`` is a sequence of (pattern, repeats); each pattern
entry is "<mixer>:<ffn>". Parameters for each pattern position carry a
leading ``repeats`` dim, as in the JAX tree, and ``forward`` loops over
it. Every layer kind of the JAX package runs: the mixers ``gqa``,
``mla`` (DeepSeek-V3's latent attention), ``mamba``, ``mlstm`` and
``slstm``; the FFNs ``dense``, ``moe`` and Arctic's ``moe_dense`` (the
MoE's output plus a dense FFN's beside it, on the same normed input).
``layer_apply`` returns the layer's MoE aux loss beside its output and
``forward`` sums it over the layers; under autograd it recomputes each
repeat of each segment in the backward pass (``remat=True``, the
reference's default). ``embed_inputs`` puts a
``tokens+prefix`` config's precomputed prefix embeddings (InternVL2's
patch embeddings) before the token embeddings. A config with
``mtp_depth`` has DeepSeek-V3's multi-token-prediction head: ``loss_fn``
adds 0.3 times the loss of predicting the token two ahead (its layer's
aux loss dropped, as in the reference); serving never reads it.

Serving: ``prefill`` is the full-sequence forward with the LM head on the
last position only (``impl="kernel"`` runs attention through K5, the
Mamba scan through K6 and the mLSTM recurrence through K7);
``init_cache`` / ``decode_step`` run one token against a per-layer cache:
a KV cache for attention, the latent ``c_kv`` / ``k_rope`` cache for
MLA, the conv tail and SSM state for Mamba, the recurrent state for
xLSTM. The cache is a list of segments, each
``{"p<j>": ...}`` with a leading ``repeats`` dim as in the JAX tree,
allocated for real (JAX broadcasts one layer's zeros) because
``decode_step`` updates it in place; ``reset_cache_`` gives it back its
initial values in place.

Spans (``repro_torch.spans``, off by default): ``rt.embed``, each layer's
``rt.mixer.<kind>`` (its norm, mixer and residual) and ``rt.ffn.<kind>``
(its FFN half), ``rt.head``, and ``rt.prefill`` around a prefill.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.device import MetaGenerator, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (dense_init, embed_apply, embed_init,
                                       ffn_apply, ffn_init, lm_head_apply,
                                       rmsnorm_apply, rmsnorm_init,
                                       softmax_xent)
from repro_torch.sharding.constrain import constrain
from repro_torch.tree import leaves, tree_map, unflatten_like

PORTED_KINDS = ("gqa:dense", "gqa:moe_dense", "mla:dense", "mla:moe",
                "mamba:dense", "mamba:moe", "mlstm:-", "slstm:-")
INPUT_MODES = ("tokens", "tokens+prefix")
_MIXER_INIT = {"gqa": attn.attn_init, "mla": mla_mod.mla_init,
               "mamba": mam.mamba_init, "mlstm": xl.mlstm_init,
               "slstm": xl.slstm_init}
_MIXER_DECODE = {"gqa": attn.attn_decode, "mla": mla_mod.mla_decode,
                 "mamba": mam.mamba_decode, "mlstm": xl.mlstm_decode,
                 "slstm": xl.slstm_decode}
_MIXER_CACHE_RESET = {"gqa": attn.attn_cache_reset_,
                      "mla": mla_mod.mla_cache_reset_,
                      "mamba": mam.mamba_state_reset_,
                      "mlstm": xl.mlstm_state_reset_,
                      "slstm": xl.slstm_state_reset_}
_MIXER_SPAN = {"gqa": "rt.mixer.attention", "mla": "rt.mixer.mla",
               "mamba": "rt.mixer.mamba", "mlstm": "rt.mixer.mlstm",
               "slstm": "rt.mixer.slstm"}
_FFN_SPAN = {f: "rt.ffn." + f for f in ("dense", "moe", "moe_dense")}


def _check_kind(kind):
    if kind not in PORTED_KINDS:
        raise ValueError(f"unknown layer kind {kind!r} (known: "
                         f"{PORTED_KINDS})")


def _check_supported(cfg):
    for pattern, _ in cfg.segments:
        for kind in pattern:
            _check_kind(kind)
    if cfg.input_mode not in INPUT_MODES:
        raise ValueError(f"unknown input_mode {cfg.input_mode!r} (known: "
                         f"{INPUT_MODES})")


def layer_init(gen, kind, cfg, dtype, stack=()):
    mixer, ffn = kind.split(":")
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, stack, gen.device)}
    p["mixer"] = _MIXER_INIT[mixer](gen, cfg, dtype, stack)
    if ffn != "-":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, stack, gen.device)
        if ffn == "dense":
            p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, stack)
        elif ffn == "moe":
            p["ffn"] = moe_mod.moe_init(gen, cfg, dtype, stack)
        else:                                   # Arctic: MoE ∥ dense
            p["ffn"] = {"moe": moe_mod.moe_init(gen, cfg, dtype, stack),
                        "dense": ffn_init(gen, cfg.d_model, cfg.d_ff,
                                          dtype, stack)}
    return p


def _ffn_residual(p, kind, x, cfg):
    """The FFN half of a layer -> (x, the MoE aux loss or None)."""
    ffn = kind.split(":")[1]
    if ffn == "-":
        return x, None
    aux = None
    with spans.span(_FFN_SPAN[ffn]):
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        if ffn == "dense":
            y = ffn_apply(p["ffn"], h)
        elif ffn == "moe":
            y, aux = moe_mod.moe_apply(p["ffn"], h, cfg)
        else:
            y, aux = moe_mod.moe_apply(p["ffn"]["moe"], h, cfg)
            y = y + ffn_apply(p["ffn"]["dense"], h)
        return x + y, aux


def layer_apply(p, kind, x, cfg, positions, impl="ref"):
    """One layer over a whole sequence -> (x, aux loss)."""
    mixer = kind.split(":")[0]
    with spans.span(_MIXER_SPAN[mixer]):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        if mixer == "gqa":
            y, _ = attn.attn_apply(p["mixer"], h, cfg, positions, impl)
        elif mixer == "mla":
            y, _ = mla_mod.mla_apply(p["mixer"], h, cfg, positions, impl)
        elif mixer == "mamba":
            y = mam.mamba_apply(p["mixer"], h, cfg, impl)
        elif mixer == "mlstm":
            y = xl.mlstm_apply(p["mixer"], h, cfg, impl)
        else:
            y = xl.slstm_apply(p["mixer"], h, cfg, impl)
        x = x + y
    x, aux = _ffn_residual(p, kind, x, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return constrain(x, ("dp", "r", "r")), aux


def layer_cache_init(kind, cfg, batch, seq_len, dtype, device, stack=()):
    _check_kind(kind)
    mixer = kind.split(":")[0]
    if mixer == "gqa":
        return attn.attn_cache_init(cfg, batch, seq_len, dtype, device,
                                    stack)
    if mixer == "mla":
        return mla_mod.mla_cache_init(cfg, batch, seq_len, dtype, device,
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
    mixer = kind.split(":")[0]
    with spans.span(_MIXER_SPAN[mixer]):
        h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
        y, cache = _MIXER_DECODE[mixer](p["mixer"], h, cfg, cache, pos)
        x = x + y
    x, _ = _ffn_residual(p, kind, x, cfg)
    return x, cache


def init_params(seed, cfg, dtype=torch.bfloat16, device=None):
    """Random params with the JAX tree's keys, nesting and shapes.

    ``seed`` is an int or a ``torch.Generator`` (whose device must then be
    ``device``). The numbers differ from ``jax.random``'s for the same
    seed; tests that compare the packages initialise in JAX and carry the
    params across with ``checkpoint.io.params_from_numpy``. On ``meta``
    the tree is shapes and dtypes only (``launch/steps.params_shapes``):
    nothing is drawn or allocated."""
    dev = resolve_device(device)
    _check_supported(cfg)
    if isinstance(seed, torch.Generator):
        gen = seed
    else:
        gen = (MetaGenerator() if dev.type == "meta"
               else torch.Generator(device=dev))
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
    if cfg.mtp_depth:                                   # DeepSeek-V3 MTP head
        params["mtp"] = {
            "proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype),
            "norm_h": rmsnorm_init(cfg.d_model, dtype, (), dev),
            "norm_e": rmsnorm_init(cfg.d_model, dtype, (), dev),
            "layer": layer_init(gen, _mtp_kind(cfg), cfg, dtype, stack=(1,)),
        }
    return params


def _mtp_kind(cfg):
    """The MTP layer's kind: the last segment's last pattern entry."""
    return cfg.segments[-1][0][-1]


def embed_inputs(params, cfg, batch):
    """batch: dict with 'tokens' (B,S_t) and, for a ``tokens+prefix``
    config, 'prefix' (B,P,D), cast to the embeddings' dtype and put
    before them -> (B, P + S_t, D)."""
    x = embed_apply(params["embed"], batch["tokens"])
    if cfg.input_mode == "tokens+prefix":
        x = torch.cat([batch["prefix"].to(x.dtype), x], dim=1)
    # activations batch-sharded only: the table's FSDP dim must not leak
    # a data-sharded d_model into the residual stream
    return constrain(x, ("dp", "r", "r"))


def _repeats(seg_params, repeats):
    """Each repeat's slice of a segment's stacked params, from ONE unbind
    per leaf: its backward is one stack, where indexing each repeat would
    zero a whole stacked gradient and add it, a repeat (O(R²) bytes and a
    stacked leaf's worth of temporaries). A DTensor leaf whose repeats
    dim is sharded (the reference's templates put ``model`` there for a
    stacked dense FFN leaf, see ``sharding/specs.py``) is made whole
    along it first."""
    unbound = [constrain(t, ("r",) + (None,) * (t.ndim - 1)).unbind(0)
               for t in leaves(seg_params)]
    return [unflatten_like(seg_params, [u[r] for u in unbound])
            for r in range(repeats)]


def _repeat(p_r, pattern, cfg, x, positions, impl):
    """One repeat of a segment: its pattern's layers on the repeat's
    params ``p_r`` -> (x, the summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, kind in enumerate(pattern):
        x, a = layer_apply(p_r[f"p{j}"], kind, x, cfg, positions, impl)
        aux = aux + a
    return x, aux


def forward(params, cfg, batch, impl="ref", remat=True, return_hidden=False,
            apply_head=True):
    """Returns (logits, aux_loss[, hidden]); ``logits`` is None when
    ``apply_head`` is False; ``aux_loss`` sums the MoE layers' Switch
    losses (0 without MoE).

    ``remat`` (the reference's default, True) recomputes each repeat of
    each segment in the backward pass, as the reference's
    ``jax.checkpoint`` of its scan body does: the repeat runs under one
    non-reentrant ``torch.utils.checkpoint`` (no RNG state: reading the
    CUDA RNG raises inside a graph capture), whose inputs are the
    repeat's slices of the stacked params (one unbind per leaf a
    forward, ``_repeats``), the residual stream and the positions, so
    only a repeat's input is kept for the backward pass. It nests with
    ``layers.chunked_scan``'s checkpoints of the recurrences. Without
    autograd (prefill, decode, ``torch.no_grad``) it does nothing, as
    ``jax.checkpoint`` does nothing outside differentiation. With
    ``remat=False`` every layer's activations are kept."""
    _check_supported(cfg)
    with spans.span("rt.embed"):
        x = embed_inputs(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    recompute = remat and torch.is_grad_enabled()
    for seg_params, (pattern, repeats) in zip(params["segments"],
                                              cfg.segments):
        for p_r in _repeats(seg_params, repeats):
            if recompute:
                x, a = checkpoint(_repeat, p_r, pattern, cfg, x, positions,
                                  impl, use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = _repeat(p_r, pattern, cfg, x, positions, impl)
            aux = aux + a
    h = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = None
    if apply_head:
        with spans.span("rt.head"):
            logits = lm_head_apply(params["embed"], params.get("head"), h,
                                   cfg.tie_embeddings)
        logits = constrain(logits, ("dp", "r", "model"))  # vocab sharded
    if return_hidden:
        return logits, aux, h
    return logits, aux


def loss_fn(params, cfg, batch, impl="ref", remat=True):
    """Next-token LM loss (+aux, +MTP when configured). labels: -1 =
    ignore. Returns (loss, metrics). ``remat`` as in ``forward``; the MTP
    head is outside the segments and is not recomputed, as in the
    reference."""
    need_h = bool(cfg.mtp_depth)
    out = forward(params, cfg, batch, impl, remat, return_hidden=need_h)
    logits, aux = out[0], out[1]
    loss = softmax_xent(logits, batch["labels"])
    metrics = {"lm_loss": loss, "aux_loss": aux}
    if need_h:
        mtp_loss = _mtp_loss(params, cfg, batch, out[2], impl)
        metrics["mtp_loss"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    total = loss + aux
    metrics["loss"] = total
    return total, metrics


def _mtp_loss(params, cfg, batch, h, impl):
    """DeepSeek-V3's depth-1 MTP: the normed hidden state at t beside the
    normed input embedding at t + 1, projected back to D, through one
    layer of the last kind (its aux loss dropped, as in the reference),
    the shared final norm and head, predicting the label at t + 2."""
    mtp = params["mtp"]
    B, S = h.shape[0], h.shape[1]
    emb = embed_inputs(params, cfg, batch)
    h_in = torch.cat(
        [rmsnorm_apply(mtp["norm_h"], h[:, :S - 1], cfg.norm_eps),
         rmsnorm_apply(mtp["norm_e"], emb[:, 1:], cfg.norm_eps)], -1)
    x2 = h_in @ mtp["proj"]["w"]
    positions = torch.arange(S - 1, dtype=torch.int32,
                             device=h.device).expand(B, S - 1)
    x2, _ = layer_apply(tree_map(lambda t: t[0], mtp["layer"]),
                        _mtp_kind(cfg), x2, cfg, positions, impl)
    h2 = rmsnorm_apply(params["final_norm"], x2, cfg.norm_eps)
    logits2 = lm_head_apply(params["embed"], params.get("head"), h2,
                            cfg.tie_embeddings)
    labels = batch["labels"]
    mtp_labels = torch.cat(
        [labels[:, 2:], torch.full((B, 1), -1, dtype=labels.dtype,
                                   device=labels.device)], dim=1)
    return softmax_xent(logits2, mtp_labels)


# ---------------------------------------------------------------------------
# Serving: prefill and one-token decode
# ---------------------------------------------------------------------------
def init_cache(cfg, batch, seq_len, dtype=torch.bfloat16, device=None):
    """Per pattern position of every segment, with a leading ``repeats``
    dim: a zero ``(repeats, B, S, KV, hd)`` k/v pair for attention, the
    zero latent pair (``mla.mla_cache_init``) for MLA, the
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
    with spans.span("rt.prefill"):
        _, _, h = forward(params, cfg, batch, impl, remat=False,
                          return_hidden=True, apply_head=False)
        with spans.span("rt.head"):
            logits = lm_head_apply(params["embed"], params.get("head"),
                                   h[:, -1:], cfg.tie_embeddings)
        return constrain(logits, ("dp", "r", "model"))[:, 0]


def count_params(params):
    return sum(t.numel() for t in leaves(params))
