"""Step functions, ported from ``repro/launch/steps.py``.

The prefill step, the JAX package's entry to the flash attention,
selective scan and mLSTM kernels: ``make_prefill_step(cfg,
impl="kernel")`` runs every attention layer through K5, every Mamba layer
through K6, every mLSTM layer through K7 and every sLSTM layer through
the captured recurrence (``xlstm.slstm_scan``); and the serve step, one
token through ``transformer.decode_step`` (the step ``ServeLoop``
captures).
The pod-mesh steps are still to port (ROADMAP.md queue 1, the pod path).
"""
from __future__ import annotations

from repro_torch.models import transformer as tr


def make_prefill_step(cfg, impl="ref"):
    """``prefill_step(params, batch)`` -> last-position logits (B, V)."""
    def prefill_step(params, batch):
        return tr.prefill(params, cfg, batch, impl)
    return prefill_step


def make_serve_step(cfg):
    """``serve_step(params, cache, token, pos)`` -> (logits (B, 1, V),
    cache), the cache updated in place. The reference's ``lowering`` knob
    picks a JAX scan lowering and has no counterpart here."""
    def serve_step(params, cache, token, pos):
        return tr.decode_step(params, cfg, cache, token, pos)
    return serve_step
