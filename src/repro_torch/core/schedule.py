"""Learning-rate math (Eq. 3 family) and the Eq. 4 metric, ported from
``repro/core/schedule.py``.

CLR — the paper's "modified cyclical learning rate": within round *i* the
rate decays exponentially from the shared η^i over the round's T_i epochs,
``η_j^i = η^i · r^(j/T_i)`` (r = 1/4), and restarts at η^i when the next
round begins. ELR — the non-cyclical ablation baseline, annealed over
global epochs. The formulas take host scalars (the python engine
evaluates them once per epoch) or 0-d device tensors.

``switch_lr`` is the combinator the fused engine embeds: every built-in
schedule selects among the same three branches (``LR_*``) with its
branch index and parameter pack riding in as device tensors, so a
schedule swap or a per-round re-parameterisation reuses the captured
round graphs. ``divergence_tensor`` is the divergence-gated sync
policy's metric (Kamp et al.) as the fused engine's gate graph computes
it (its ``live=`` form measures the live rows only).
``EpochController`` is the legacy flag-driven Eq. 4 controller.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
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
    x = math.pi * (epoch_j / T_i)
    phase = torch.cos(x) if isinstance(x, torch.Tensor) else math.cos(x)
    return eta_min + 0.5 * (eta_i - eta_min) * (1.0 + phase)


# --- the shared device combinator -------------------------------------------
# Branch indices of ``switch_lr``. Every built-in LRSchedule lowers to the
# same selection over these branches with (kind, p) as device tensors, so
# the fused engine's captured graphs are reused across schedule swaps and
# per-round re-parameterisations (e.g. a warmup ramping η^i).
LR_EXP_ROUND = 0      # η · r^(j/T_i)            — CLR / WarmupCLR (Eq. 3)
LR_EXP_GLOBAL = 1     # η · r^(ge/total)         — ELR
LR_COS_ROUND = 2      # cosine anneal within the round, per-round restart
N_SCHED_PARAMS = 4    # fixed length of the parameter vector ``p``


def switch_lr(sched, epoch_j, T_i, global_epoch, total_epochs):
    """The per-epoch learning rate shared by all built-in schedules, as a
    0-d f32 device tensor.

    ``sched`` is ``{"kind": int32 0-d, "p": float32[N_SCHED_PARAMS]}`` —
    the device form of ``LRSchedule.round_params`` — with ``p = [eta_i,
    decay_rate, aux0, aux1]``; ``epoch_j``, ``T_i``, ``global_epoch`` and
    ``total_epochs`` are 0-d int32 device tensors. All three branches are
    computed and ``torch.where`` selects one (an index outside the range
    clamps to it, as ``lax.switch`` does): nothing here branches on a
    device value on the host, and every quotient divides by a device
    tensor.
    """
    p = sched["p"]
    kind = sched["kind"].clamp(LR_EXP_ROUND, LR_COS_ROUND)
    exp_round = clr_lr(p[0], p[1], epoch_j, T_i)
    exp_global = elr_lr(p[0], p[1], global_epoch,
                        torch.clamp(total_epochs, min=1))
    cos_round = cosine_lr(p[0], p[2], epoch_j, T_i)
    return torch.where(kind == LR_EXP_ROUND, exp_round,
                       torch.where(kind == LR_EXP_GLOBAL, exp_global,
                                   cos_round))


def round_lr(colearn_cfg, round_i: int, epoch_j, T_i: int, global_epoch,
             total_epochs: int):
    """Legacy flag-surface helper: the per-epoch rate under the config's
    ``schedule`` string ("clr" | "elr"); new code goes through
    ``api.get_schedule(...).lr(...)``."""
    if colearn_cfg.schedule == "clr":
        return clr_lr(colearn_cfg.eta0, colearn_cfg.decay_rate, epoch_j, T_i)
    return elr_lr(colearn_cfg.eta0, colearn_cfg.decay_rate, global_epoch,
                  max(total_epochs, 1))


# ---------------------------------------------------------------------------
# Eq. 4 controller (legacy shim — see api.SyncPolicy for the protocol form)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EpochController:
    """Server-side state deciding T_i each round (Eq. 4): the legacy
    flag-driven controller; ``api.ILE`` / ``api.FLE`` /
    ``api.DivergenceTrigger`` on an ``api.SyncState`` replace it."""
    T: int
    epsilon: float
    rule: str = "ile"                 # ile | fle
    history: tuple = ()               # (round, rel_change, T) triples

    def update(self, rel_change: float) -> "EpochController":
        """Called after round i computed w̄^i; returns the controller for
        round i + 1. The stored round index counts the updates so far."""
        T = self.T
        if self.rule == "ile" and rel_change <= self.epsilon:
            T = 2 * self.T
        entry = (len(self.history), rel_change, T)
        return dataclasses.replace(self, T=T, history=self.history + (entry,))


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


@torch.no_grad()
def divergence_tensor(stacked, ref, live=None):
    """Kamp-style (1807.03210) local-model divergence as a 0-d f32 device
    tensor (no host sync): the RMS over the K participants of the drift
    from the last synced shared model, relative to that model's norm,
    ``sqrt(mean_k ‖w_k − w_ref‖²) / ‖w_ref‖``.

    ``live`` (elastic membership): the ``(K,)`` 0/1 liveness row (a device
    tensor); the RMS then runs over the live participants only, so a dead
    slot's stale parameters neither inflate nor dilute the drift."""
    num, den = divergence_sums(stacked, ref, live)
    K = leaves(stacked)[0].shape[0]
    n = K if live is None else torch.clamp(live.float().sum(), min=1.0)
    return (torch.sqrt(num / n)
            / torch.clamp(torch.sqrt(den), min=1e-12))


@torch.no_grad()
def divergence_sums(stacked, ref, live=None):
    """The divergence's two sums (0-d f32): ``Σ_k live_k ‖w_k − w_ref‖²``
    over the given rows and ``‖w_ref‖²`` (the pod gate adds the first
    over every rank's rows)."""
    num, den = [], []
    w = None if live is None else live.float()
    for t, r in zip(leaves(stacked), leaves(ref)):
        rf = r.float()
        d = t.float() - rf[None]
        if w is None:
            num.append(torch.sum(d * d))
        else:
            per_k = torch.sum(d * d, dim=tuple(range(1, d.ndim)))
            num.append(torch.sum(w * per_k))
        den.append(torch.sum(rf * rf))
    return torch.stack(num).sum(), torch.stack(den).sum()


def divergence(stacked, ref, live=None) -> float:
    """Host-facing divergence: the sums stay on the device and the result
    crosses to the host once. ``live`` may be a host bool row."""
    if live is not None and not isinstance(live, torch.Tensor):
        live = torch.as_tensor(np.asarray(live, np.float32),
                               device=leaves(stacked)[0].device)
    return float(divergence_tensor(stacked, ref, live).item())
