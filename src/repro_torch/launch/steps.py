"""Step functions, ported from ``repro/launch/steps.py``.

Only the prefill step so far, the JAX package's entry to the flash
attention, selective scan and mLSTM kernels: ``make_prefill_step(cfg,
impl="kernel")`` runs every attention layer through K5, every Mamba layer
through K6 and every mLSTM layer through K7.
The pod-mesh steps are still to port (ROADMAP.md queue 1, the pod path).
"""
from __future__ import annotations

from repro_torch.models import transformer as tr


def make_prefill_step(cfg, impl="ref"):
    """``prefill_step(params, batch)`` -> last-position logits (B, V)."""
    def prefill_step(params, batch):
        return tr.prefill(params, cfg, batch, impl)
    return prefill_step
