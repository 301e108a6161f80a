"""Model averaging (Eq. 2) over stacked participants, simulation path —
ported from ``repro/core/averaging.py``.

Participants are stacked along a leading K dim on one device. The
distributed counterparts (``make_average_shard_map``, the pod-pinned
``participant_step``) are still to port (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map


def stack_participants(params, K: int):
    """K stacked participant copies of a params tree (real copies: the
    port trains each slot in place)."""
    return tree_map(
        lambda t: t[None].expand(K, *t.shape).contiguous(), params)


def unstack_participant(stacked, k: int):
    """A copy of slot k of a stacked (K, ...) tree."""
    return tree_map(lambda t: t[k].clone(), stacked)


@torch.no_grad()
def average_pjit(stacked, live=None):
    """Eq. 2: w̄ = (1/K) Σ_k w_k (f32), written back into all K slots IN
    PLACE; returns ``stacked``. ``live`` (a ``(K,)`` liveness row): only
    the live slots are written (the mean still runs over all K: the
    naive-membership ablation's static matrix)."""
    for t in leaves(stacked):
        mean = torch.mean(t.float(), dim=0, keepdim=True).to(t.dtype)
        if live is None:
            t.copy_(mean)
        else:
            alive = (live > 0).reshape((-1,) + (1,) * (t.ndim - 1))
            t.copy_(torch.where(alive, mean, t))
    return stacked
