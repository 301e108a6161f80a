"""Model averaging (Eq. 2) and participant-parallel training wrappers,
ported from ``repro/core/averaging.py``.

Simulation path: participants stacked along a leading K dim on one
device (``average_pjit``). Pod path: one process per participant, each
holding its ``(1, ...)`` slice (DTensors over the pod's other axes on
an intra-pod mesh); ``make_average_shard_map`` is the reference's
``shard_map`` psum as one f32 ``all_reduce`` per leaf (per local shard)
over the mesh's ``pod`` group (``core/collectives.py``), then ``/ K``.
``participant_step`` runs a one-participant step over every row the
process holds: all K in the simulation, the rank's own row on the pod.
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import PodAxis, local
from repro_torch.tree import leaves, tree_map


def stack_participants(params, K: int):
    """K stacked participant copies of a params tree (real copies: the
    port trains each slot in place)."""
    return tree_map(
        lambda t: t[None].expand(K, *t.shape).contiguous(), params)


def unstack_participant(stacked, k: int):
    """A copy of slot k of a stacked (K, ...) tree."""
    return tree_map(lambda t: t[k].clone(), stacked)


def _write_rows(t, new, live):
    """``t.copy_(new)`` on every row, or with a ``(rows,)`` liveness row on
    the live ones only."""
    if live is None:
        t.copy_(new)
    else:
        alive = (live > 0).reshape((-1,) + (1,) * (t.ndim - 1))
        t.copy_(torch.where(alive, new, t))


def average_mean(stacked):
    """Eq. 2 returning the un-stacked average (f32 mean, the leaves'
    dtypes)."""
    return tree_map(lambda t: torch.mean(t.float(), dim=0).to(t.dtype),
                    stacked)


@torch.no_grad()
def average_pjit(stacked, live=None):
    """Eq. 2: w̄ = (1/K) Σ_k w_k (f32), written back into all K slots IN
    PLACE; returns ``stacked``. ``live`` (a ``(K,)`` liveness row): only
    the live slots are written (the mean still runs over all K: the
    naive-membership ablation's static matrix)."""
    for t in leaves(stacked):
        _write_rows(t, torch.mean(t.float(), dim=0, keepdim=True).to(t.dtype),
                    live)
    return stacked


def make_average_shard_map(mesh, param_specs=None, axis="pod"):
    """Explicit-collective averaging over the ``axis`` of ``mesh``: each
    rank's ``(1, ...)`` leaves summed in f32 over the pods, divided by K
    and written back in place (``live``: the rank's entry of the whole
    ``(K,)`` liveness row gates the write). ``param_specs`` (the
    reference's in/out specs) are not needed: on a mesh with intra-pod
    axes a row's leaves are DTensors, and each rank sums its local shards
    over its pod group (every pod places a leaf alike)."""
    del param_specs
    pod = PodAxis(mesh, axis)

    @torch.no_grad()
    def average(rows, live=None):
        ls = [local(t) for t in leaves(rows)]
        sums = [t.float() for t in ls]
        sums = [s.clone() if s is t else s for s, t in zip(sums, ls)]
        pod.all_reduce_(sums)
        K = torch.full((), float(pod.size), device=ls[0].device)
        for t, s in zip(ls, sums):
            _write_rows(t, torch.div(s, K).to(t.dtype), pod.local(live))
        return rows
    average.pod = pod
    return average


def participant_step_sim(step_fn):
    """Run ``step_fn(params, batch, *args) -> (params', metrics)`` for
    every participant row of the stacked arguments (every argument leads
    with the participant dim, as under ``jax.vmap``'s default axes) and
    stack the results."""
    def stepped(*args):
        K = leaves(args[0])[0].shape[0]
        outs = [step_fn(*tree_map(lambda t, _k=k: t[_k], args))
                for k in range(K)]
        return tree_map(lambda *xs: torch.stack(xs), *outs)
    return stepped


def participant_step(step_fn):
    """The pod form: the reference pins the vmap to the ``pod`` mesh axis
    so no reduction crosses pods during local training. Here each rank
    holds its own ``(1, ...)`` rows and runs them alone, so it is
    ``participant_step_sim`` over the local rows."""
    return participant_step_sim(step_fn)
