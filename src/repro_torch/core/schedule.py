"""Learning-rate math (Eq. 3 family) and the Eq. 4 metric, ported from
``repro/core/schedule.py``.

CLR — the paper's "modified cyclical learning rate": within round *i* the
rate decays exponentially from the shared η^i over the round's T_i epochs,
``η_j^i = η^i · r^(j/T_i)`` (r = 1/4), and restarts at η^i when the next
round begins. ELR — the non-cyclical ablation baseline, annealed over
global epochs. The rates are host scalars: the python engine evaluates
them once per epoch.

The traced combinator ``switch_lr`` and the divergence metric belong to
the fused engine and the divergence-gated sync policy, which are still to
port (ROADMAP.md).
"""
from __future__ import annotations

import math

import torch

from repro_torch.tree import leaves


def clr_lr(eta_i: float, decay_rate: float, epoch_j, T_i):
    """Eq. 3: η_j^i = η^i · r^(j/T_i)."""
    return eta_i * decay_rate ** (epoch_j / T_i)


def elr_lr(eta_0: float, decay_rate: float, global_epoch, total_epochs):
    """Non-cyclical baseline: one long anneal over the whole run."""
    return eta_0 * decay_rate ** (global_epoch / total_epochs)


def cosine_lr(eta_i: float, eta_min: float, epoch_j, T_i):
    """Cosine anneal within the round, restarting at η^i each round (the
    SGDR-style cyclical variant of Eq. 3)."""
    phase = math.cos(math.pi * (epoch_j / T_i))
    return eta_min + 0.5 * (eta_i - eta_min) * (1.0 + phase)


@torch.no_grad()
def relative_change_tensor(new_avg, old_avg):
    """Eq. 4 metric as a 0-d f32 device tensor (no host sync):
    ‖w̄^i − w̄^{i−1}‖ / ‖w̄^{i−1}‖ over the whole parameter tree."""
    num, den = [], []
    for a, b in zip(leaves(new_avg), leaves(old_avg)):
        bf = b.float()
        d = a.float() - bf
        num.append(torch.sum(d * d))
        den.append(torch.sum(bf * bf))
    num = torch.stack(num).sum()
    den = torch.stack(den).sum()
    return torch.sqrt(num) / torch.clamp(torch.sqrt(den), min=1e-12)


def relative_change(new_avg, old_avg) -> float:
    """Host-facing Eq. 4 metric: the per-leaf sums stay on the device and
    the result crosses to the host once."""
    return float(relative_change_tensor(new_avg, old_avg).item())
