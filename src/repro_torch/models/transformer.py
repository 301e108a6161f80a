"""Model assembly, ported from ``repro/models/transformer.py``.

A config's ``segments`` is a sequence of (pattern, repeats); each pattern
entry is "<mixer>:<ffn>". Parameters for each pattern position carry a
leading ``repeats`` dim, as in the JAX tree, and ``forward`` loops over
it. The port runs ``gqa:dense`` layers; every other mixer and FFN (MLA,
Mamba, xLSTM, MoE), the multi-token-prediction head, the prefix input
mode and the decode path are still to port (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense_init, embed_apply, embed_init,
                                       ffn_apply, ffn_init, lm_head_apply,
                                       rmsnorm_apply, rmsnorm_init,
                                       softmax_xent)
from repro_torch.tree import leaves, tree_map

PORTED_KINDS = ("gqa:dense",)


def _check_supported(cfg):
    for pattern, _ in cfg.segments:
        for kind in pattern:
            if kind not in PORTED_KINDS:
                raise NotImplementedError(
                    f"layer kind {kind!r} not yet ported, see ROADMAP.md "
                    f"(ported: {PORTED_KINDS})")
    if cfg.mtp_depth:
        raise NotImplementedError(
            "multi-token prediction not yet ported, see ROADMAP.md")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input_mode {cfg.input_mode!r} not yet ported, see ROADMAP.md")


def layer_init(gen, kind, cfg, dtype, stack=()):
    _, ffn = kind.split(":")
    p = {"norm1": rmsnorm_init(cfg.d_model, dtype, stack, gen.device)}
    p["mixer"] = attn.attn_init(gen, cfg, dtype, stack)
    if ffn != "-":
        p["norm2"] = rmsnorm_init(cfg.d_model, dtype, stack, gen.device)
        p["ffn"] = ffn_init(gen, cfg.d_model, cfg.d_ff, dtype, stack)
    return p


def layer_apply(p, kind, x, cfg, positions):
    h = rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    y, _ = attn.attn_apply(p["mixer"], h, cfg, positions)
    x = x + y
    if "ffn" in p:
        h = rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + ffn_apply(p["ffn"], h)
    return x


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


def forward(params, cfg, batch):
    """Returns (logits, aux_loss). Every layer's activations are kept for
    the backward pass: the per-layer recomputation of the JAX package
    (``remat``) is not ported yet (ROADMAP.md)."""
    _check_supported(cfg)
    x = embed_apply(params["embed"], batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    for seg_params, (pattern, repeats) in zip(params["segments"],
                                              cfg.segments):
        for r in range(repeats):
            for j, kind in enumerate(pattern):
                p_r = tree_map(lambda t, _r=r: t[_r], seg_params[f"p{j}"])
                x = layer_apply(p_r, kind, x, cfg, positions)
    h = rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    logits = lm_head_apply(params["embed"], params.get("head"), h,
                           cfg.tie_embeddings)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, cfg, batch):
    """Next-token LM loss. labels: -1 = ignore. Returns (loss, metrics)."""
    logits, aux = forward(params, cfg, batch)
    loss = softmax_xent(logits, batch["labels"])
    total = loss + aux
    return total, {"lm_loss": loss, "aux_loss": aux, "loss": total}


def count_params(params):
    return sum(t.numel() for t in leaves(params))
