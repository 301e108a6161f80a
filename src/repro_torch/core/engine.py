"""The local epoch, the fused round engine and the fused Eq. 2 wire step,
ported from ``repro/core/engine.py``.

``make_epoch_fn`` is the port's counterpart of the JAX vmapped epoch: an
explicit loop over the K participants. Each step takes
``leaf[k].detach().requires_grad_()`` views of participant k's slot,
computes the loss and ``torch.autograd.grad``, and writes the optimizer
update back into the stacked storage IN PLACE. It holds one
participant's gradients at a time, where the vmap holds K; the step
losses stay on the device.

The fused round (``make_fused_round``) is the T_i epochs with the Eq. 3
schedule computed on the device (``schedule.switch_lr``: the parameter
pack, ``j0``, ``T_i``, the global-epoch offset and the epoch budget are
all 0-d device tensors), then the aggregation, the Eq. 4 metric and the
optimizer reset. Long rounds chain ``make_fused_epochs`` chunks and one
``make_fused_finalize``. Where JAX returns new arrays from a donated
executable, these functions write their results into the storage they
are given — the stacked params, the optimizer state, the residual and
the last shared model ``old_avg`` — so the same functions run eagerly on
the CPU and as CUDA graphs captured once and replayed on the card
(``core/graphs.py``, driven by ``api.FusedEngine``): a captured graph
reads and writes fixed addresses, and only its temporaries live in the
graph pool. ``stage`` / ``stack_epoch_batches`` are the round's one
designated host-to-device staging.

``make_fused_compressed_average`` is the simulation-path (``mesh=None``)
Eq. 2 fast path of ``FlatFusedIntN``: the stacked params are flattened
into one ``(K, N_pad)`` f32 buffer and ONE fused quantize -> average ->
dequantize pass (K3, or K4 with error feedback) computes the mean, which
is written back into the stacked params in place.

The ragged-shard batch mask (``masked=``) rides into the epochs as a
device tensor. The divergence gate (``gated=``) is ``make_fused_gate``
plus the finalize: the reference selects between the synced and the quiet
state on the device (``lax.cond``), which a captured graph cannot, so the
fused runner replays the gate, reads its decision and replays the
finalize only on a synced round.

The liveness row of elastic membership (``live=``) is one ``(K,)`` f32
device tensor, read like the batch mask: a dead participant's steps
commit nothing (``torch.where``), its epoch loss is 0 with a zero weight,
and after the aggregation ``select_live`` writes the new rows only into
the live slots, so a dead row keeps its params, optimizer state and
round state. The new shared model is the first live row (``first_live``:
an ``argmax`` on the device). One captured graph serves every live set.

The pod path (``spmd_axis_name="pod"``, an aggregate built against a
mesh): one process per participant, each holding the ``(1, ...)`` slice
of the stacked trees. The epochs run unchanged on that slice. The
aggregate carries its ``collectives.PodAxis`` (``aggregate.pod``), and
the finalize then writes the rank's own row, reads the new shared model
from the first live rank (which computes Eq. 4 against its ``old_avg``
and broadcasts both), and the round gathers the ``(C, K)`` losses. The
liveness row and the mixing matrix stay whole ``(K,)`` / ``(K, K)``
tensors; the batch mask, the residual and every tree are the rank's
slice. ``make_fused_compressed_average(mesh=)`` is the reference's four
pod variants: per rank the flat buffer, K1 and K2 over its one row, the
weight where weighted, ONE f32 all-reduce of the ``(1, N_pad)`` payload
and ``/ K``; an error-feedback residual stays on its rank. The pod
collectives synchronise with the host, so a pod finalize runs eagerly
(``launch/steps.make_fused_round_step`` captures the epochs alone).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import averaging, flatbuf
from repro_torch.core.collectives import PodAxis, plain
from repro_torch.core.schedule import (divergence_sums, divergence_tensor,
                                       relative_change_tensor, switch_lr)
from repro_torch.kernels import ops as kops
from repro_torch.tree import leaves, tree_map, unflatten_like


def _on(t, dev):
    """Whether tensor ``t`` lies on ``dev`` (``cuda`` matches ``cuda:0``)."""
    return t.device.type == dev.type and dev.index in (None, t.device.index)


def stage(value, dtype=None, device=None):
    """Explicitly stage a host value (python scalar, numpy array or CPU
    tensor) onto ``device`` — the round's designated host-to-device
    transfer. On the card it goes through pinned memory and does not wait
    for the device. A tensor already on ``device`` passes through."""
    dev = torch.device("cpu" if device is None else device)
    if isinstance(value, torch.Tensor):
        if _on(value, dev):
            return value
        value = value.numpy()
    host = np.asarray(value, dtype)
    if not host.flags.c_contiguous:       # (ascontiguousarray makes 0-d 1-d)
        host = np.ascontiguousarray(host)
    host = torch.from_numpy(host)
    if dev.type != "cuda":
        return host.to(dev)
    return host.pin_memory().to(dev, non_blocking=True)


def stack_epoch_batches(per_epoch, device=None):
    """Stack a list of per-epoch ``(K, n_batches, ...)`` trees along a new
    leading epoch axis — the shape the fused epoch loop consumes. Host
    leaves (numpy, CPU tensors) are stacked host-side and staged with ONE
    transfer per leaf; tensors on ``device`` stack there."""
    dev = torch.device("cpu" if device is None else device)

    def stack(*xs):
        if all(isinstance(x, torch.Tensor) and _on(x, dev) for x in xs):
            return torch.stack(xs)
        return stage(np.stack([x.numpy() if isinstance(x, torch.Tensor)
                               else np.asarray(x) for x in xs]), device=dev)
    return tree_map(stack, *per_epoch)


def _alive(live_row, t):
    """The liveness row as a bool mask broadcast against stacked leaf
    ``t``."""
    return (live_row > 0).reshape((-1,) + (1,) * (t.ndim - 1))


@torch.no_grad()
def commit(dst, new, live_row=None):
    """Write ``new`` into the stacked leaf ``dst``: every row, or with a
    liveness row only the live ones (a dead row keeps its value)."""
    if new is dst:
        return
    if live_row is None:
        dst.copy_(new)
    else:
        dst.copy_(torch.where(_alive(live_row, dst), new, dst))


@torch.no_grad()
def select_live(live_row, new, old):
    """Per-slot identity carry over a stacked ``(K, ...)`` tree pair: the
    live rows of ``new`` are written INTO ``old``'s storage (a
    ``torch.where`` and a ``copy_`` per leaf, never a second K-tree), the
    dead rows of ``old`` stay. Leaves of ``new`` that already are
    ``old``'s storage are skipped. Returns ``old``."""
    for o, n in zip(leaves(old), leaves(new)):
        commit(o, n, live_row)
    return old


def first_live(live_row):
    """Device index (0-d) of the first live slot — the shared-model row
    under elastic membership (slot 0 may be dead). No host sync."""
    return torch.argmax(live_row)


def unstack_first_live(stacked, live_row):
    """A copy of the first LIVE participant's model (device index)."""
    idx = first_live(live_row).reshape(1)
    return tree_map(lambda t: t.index_select(0, idx)[0], stacked)


def init_stacked_opt(opt, stacked):
    """Per-participant optimizer state stacked along K (the counterpart
    of ``jax.vmap(opt.init)``)."""
    K = leaves(stacked)[0].shape[0]
    per = [opt.init(tree_map(lambda t, _k=k: t[_k], stacked))
           for k in range(K)]
    return tree_map(lambda *xs: torch.stack(xs), per[0], *per[1:])


def make_epoch_fn(loss_fn, opt, spmd_axis_name=None, masked=False,
                  live=False):
    """One local epoch for every participant row of the stacked trees.

    Returns ``epoch_fn(stacked_params, opt_state, batches, lr[, mask]
    [, live_row]) -> (stacked_params, opt_state, per-participant mean loss
    (K,))`` where ``batches`` is a tree of ``(K, n_batches, ...)`` tensors
    and ``lr`` a python float (the python engine) or a 0-d device tensor
    (the fused engine). Params and optimizer state are updated in place
    (and returned).

    ``masked=True`` is the ragged-shard variant: ``mask`` is a ``(K,
    n_batches)`` bool device tensor marking the slots that hold shard k's
    real batches. Every step computes unconditionally and commits through
    ``torch.where(valid, new, old)`` into the params and every optimizer
    leaf (AdamW's step count too), so a masked step is an exact identity
    carry; its loss is left out of the epoch mean, ``Σ where(valid, loss,
    0) / max(Σ valid, 1)``. (A rate of ``lr·valid`` would not do: ``0·inf``
    is NaN, and momentum and AdamW state would still move.) The mask is
    read on the device, so one captured graph serves every mask value.

    ``live=True`` is the elastic-membership variant: ``live_row`` is the
    ``(K,)`` f32 0/1 liveness row (after ``mask`` when both are on). A
    dead participant's commit gate is off for every step (``valid &
    alive``), and its epoch loss is 0 with a zero weight: the mean is
    ``Σ where(gate, loss, 0) / max(n·alive, 1)``.

    ``spmd_axis_name="pod"`` (the pod path) changes nothing here: the
    reference pins its vmap to the mesh axis so that no reduction crosses
    pods, and a rank runs only its own ``(1, ...)`` rows (with its own
    ``(1, n_batches)`` mask and ``(1,)`` liveness entry)."""
    del spmd_axis_name

    def epoch_fn(stacked, opt_state, batches, lr, mask=None, live_row=None):
        if masked and mask is None:
            raise ValueError("the masked epoch takes the (K, n_batches) "
                             "batch mask")
        if live and live_row is None:
            raise ValueError("the live epoch takes the (K,) liveness row")
        K = leaves(stacked)[0].shape[0]
        n_batches = leaves(batches)[0].shape[1]
        means = []
        for k in range(K):
            slot = tree_map(lambda t, _k=k: t[_k], stacked)
            ostate = tree_map(lambda t, _k=k: t[_k], opt_state)
            alive = live_row[k] > 0 if live else None
            step_losses = []
            for b in range(n_batches):
                valid = mask[k, b] if masked else None
                if alive is not None:
                    valid = alive if valid is None else valid & alive
                params = tree_map(lambda t: t.detach().requires_grad_(), slot)
                batch = tree_map(lambda t, _k=k, _b=b: t[_k, _b], batches)
                loss, _ = loss_fn(params, batch)
                grads = unflatten_like(params, torch.autograd.grad(
                    loss, leaves(params)))
                with torch.no_grad():
                    upd, new_ostate = opt.update(grads, ostate, params, lr)
                    del grads
                    for dst, u in zip(leaves(slot), leaves(upd)):
                        new = (dst.float() + u).to(dst.dtype)
                        dst.copy_(new if valid is None
                                  else torch.where(valid, new, dst))
                    del upd
                    for dst, src in zip(leaves(ostate), leaves(new_ostate)):
                        dst.copy_(src if valid is None
                                  else torch.where(valid, src, dst))
                loss = loss.detach()
                step_losses.append(loss if valid is None
                                   else torch.where(valid, loss, 0.0))
            if live:
                denom = mask[k].sum() if masked else n_batches
                means.append(torch.stack(step_losses).sum()
                             / torch.clamp(denom * live_row[k], min=1))
            elif masked:
                means.append(torch.stack(step_losses).sum()
                             / torch.clamp(mask[k].sum(), min=1))
            else:
                means.append(torch.stack(step_losses).mean())
        return stacked, opt_state, torch.stack(means)

    return epoch_fn


def _make_epoch_scan(epoch_fn, lr_fn):
    """scan_epochs(params, opt, batches, j0, T_i, ge0, sched, total,
    mask=None, live_row=None) -> ((params, opt), (losses (C, K), lrs
    (C,))): run the leading-dim epochs of ``batches`` with the rate
    computed on the device by ``lr_fn(sched, j, T_i, ge, total)``;
    ``mask`` (ragged shards) and ``live_row`` (elastic membership) are
    applied every epoch.

    ``j0`` (round-local offset of the first staged epoch), ``T_i`` (the
    round's cycle denominator), ``ge0`` (global epoch at round start) and
    ``total`` (the run's epoch budget) are 0-d int32 device tensors and
    ``sched`` the schedule's device parameter pack, so one captured chunk
    is replayed unchanged as T_i doubles, as the budget updates and across
    built-in schedule swaps."""
    def scan_epochs(stacked, opt_state, batches, j0, T_i, global_epoch0,
                    sched, total, mask=None, live_row=None):
        losses, lrs = [], []
        for c in range(leaves(batches)[0].shape[0]):
            j = j0 + c
            lr = lr_fn(sched, j, T_i, global_epoch0 + j, total)
            ebatches = tree_map(lambda t, _c=c: t[_c], batches)
            stacked, opt_state, loss = epoch_fn(stacked, opt_state,
                                                ebatches, lr, mask, live_row)
            losses.append(loss)
            lrs.append(lr)
        return (stacked, opt_state), (torch.stack(losses), torch.stack(lrs))
    return scan_epochs


def as_aggregate_fn(aggregate_fn=None, compress_fn=None, average_fn=None):
    """Normalize the aggregation surface to ``aggregate(stacked, weights,
    live=None)``.

    ``aggregate_fn`` (from a ``core/api.py`` aggregator) passes through;
    the legacy pair — an optional stacked -> stacked ``compress_fn``
    upload transform followed by a one-argument ``average_fn`` (default
    ``averaging.average_pjit``) — is wrapped, ignoring weights. Passing
    both surfaces is an error.

    The aggregate may write its result into ``stacked`` in place; given a
    liveness row (``live=``) it writes only the live rows. The legacy
    pair's ``average_fn`` knows no liveness row, so under one it averages
    a copy and the finalize keeps the dead rows."""
    if aggregate_fn is not None:
        if compress_fn is not None or average_fn is not None:
            raise ValueError(
                "pass aggregate_fn OR compress_fn/average_fn, not both")
        return aggregate_fn
    if average_fn is None:
        average_fn = averaging.average_pjit

    def aggregate(stacked, weights=None, live=None):
        del weights                     # legacy pair: statically uniform
        if compress_fn is not None:
            uploaded = compress_fn(stacked)
        elif live is not None:
            uploaded = tree_map(torch.clone, stacked)
        else:
            uploaded = stacked
        return average_fn(uploaded)
    return aggregate


@torch.no_grad()
def _write_into(dst, src):
    """Copy every leaf of ``src`` into the storage of ``dst`` (leaves that
    already are that storage are skipped); returns ``dst``."""
    for d, s in zip(leaves(dst), leaves(src)):
        if s is not d:
            d.copy_(s)
    return dst


def _make_finalize(opt, aggregate_fn, live=False, stateful=False):
    """Aggregation (Eq. 2) + Eq. 4 metric + per-participant opt reset.

    ``finalize(params, opt_state, old_avg, agg_weights=None) -> (params,
    opt_state, rel, new_avg)``. Everything is written in place: the
    aggregate into ``params``, the fresh optimizer state into
    ``opt_state`` (the paper discards the local state), and the new shared
    model (slot 0) into ``old_avg`` after ``rel`` has read it — so
    ``new_avg`` IS ``old_avg``'s storage. ``agg_weights`` is the
    aggregator's mixing matrix (None for uniform Eq. 2).

    ``stateful=True`` (error feedback, the D² correction or both): the
    round state enters right after ``opt_state``, the aggregate is
    ``aggregate_fn(params, agg_weights, residual) -> (mixed,
    new_residual)``, the new state is written into ``residual`` (any
    tree) and appended to the outputs.

    ``live=True`` (elastic membership): ``finalize(params, opt_state,
    [residual,] old_avg, live_row, agg_weights=None)``. The aggregate gets
    the liveness row and writes only live rows in place; whatever it
    returns apart is written into the live rows (``select_live``), so a
    dead row keeps its params, optimizer state and round state, and the
    new shared model is the first live row.

    An aggregate built against a mesh (``aggregate_fn.pod``) makes this
    the pod finalize (``_pod_finish``): eager, with the liveness row whole
    and everything else the rank's slice."""
    pod = getattr(aggregate_fn, "pod", None)

    @torch.no_grad()
    def finish(params, opt_state, averaged, old_avg, live_row=None):
        if pod is not None:
            return _pod_finish(pod, opt, params, opt_state, averaged,
                               old_avg, live_row)
        if live_row is None:
            _write_into(params, averaged)
            new_avg = tree_map(lambda t: t[0], params)
        else:
            select_live(live_row, averaged, params)
            new_avg = unstack_first_live(params, live_row)
        rel = relative_change_tensor(new_avg, old_avg)
        _write_into(old_avg, new_avg)
        fresh = init_stacked_opt(opt, params)
        if live_row is None:
            _write_into(opt_state, fresh)
        else:
            select_live(live_row, fresh, opt_state)
        return rel

    def aggregate(params, agg_weights, res_in, live_row):
        kw = {} if live_row is None else {"live": live_row}
        return aggregate_fn(params, agg_weights, *res_in, **kw)

    def body(params, opt_state, residual, old_avg, live_row, agg_weights):
        if stateful:
            averaged, new_res = aggregate(params, agg_weights, (residual,),
                                          live_row)
        else:
            averaged = aggregate(params, agg_weights, (), live_row)
        rel = finish(params, opt_state, averaged, old_avg, live_row)
        out = (params, opt_state, rel, old_avg)
        if stateful:
            own = live_row if pod is None else pod.local(live_row)
            if own is None:
                _write_into(residual, new_res)
            else:
                select_live(own, new_res, residual)
            out += (residual,)
        return out

    if live and stateful:
        def finalize_live_ef(params, opt_state, residual, old_avg, live_row,
                             agg_weights=None):
            return body(params, opt_state, residual, old_avg, live_row,
                        agg_weights)
        return finalize_live_ef
    if live:
        def finalize_live(params, opt_state, old_avg, live_row,
                          agg_weights=None):
            return body(params, opt_state, None, old_avg, live_row,
                        agg_weights)
        return finalize_live
    if stateful:
        def finalize_ef(params, opt_state, residual, old_avg,
                        agg_weights=None):
            return body(params, opt_state, residual, old_avg, None,
                        agg_weights)
        return finalize_ef

    def finalize(params, opt_state, old_avg, agg_weights=None):
        return body(params, opt_state, None, old_avg, None, agg_weights)
    return finalize


@torch.no_grad()
def _pod_finish(pod, opt, params, opt_state, averaged, old_avg, live_row):
    """The pod form of the finalize's state transition: the rank's own row
    of ``averaged`` into ``params`` (only if the rank is live), then the
    first live rank measures Eq. 4 of its row against its ``old_avg`` and
    writes the row into it, and ONE broadcast from that rank gives every
    rank the new shared model (into ``old_avg``) and ``rel``; the fresh
    optimizer state as in the simulation. Returns ``rel`` (0-d)."""
    own = pod.local(live_row)
    if own is None:
        _write_into(params, averaged)
    else:
        select_live(own, averaged, params)
    j = pod.first_live(live_row)
    rel = torch.zeros(1, dtype=torch.float32,
                      device=leaves(params)[0].device)
    if pod.index == j:
        row = tree_map(lambda t: t[0], params)
        rel.copy_(plain(relative_change_tensor(row, old_avg)).reshape(1))
        _write_into(old_avg, row)
    pod.broadcast_(leaves(old_avg) + [rel], j, op="new_avg")
    fresh = init_stacked_opt(opt, params)
    if own is None:
        _write_into(opt_state, fresh)
    else:
        select_live(own, fresh, opt_state)
    return rel[0]


def _pod_of(aggregate_fn, spmd_axis_name):
    """The aggregate's ``PodAxis`` when the round runs on the pod path."""
    pod = getattr(aggregate_fn, "pod", None)
    if spmd_axis_name is None:
        if pod is not None:
            raise ValueError(
                "an aggregate built against a mesh runs on the pod path; "
                f"pass spmd_axis_name={pod.axis!r}")
        return None
    if pod is None or pod.axis != spmd_axis_name:
        raise ValueError(
            f"spmd_axis_name={spmd_axis_name!r} needs an aggregate built "
            "against that mesh axis (make_aggregate_fn(codec, mesh=...))")
    return pod


def _default_gate(div, delta):
    """The default device gate (``api.SyncPolicy.traced_should_sync``)."""
    return div > delta


def make_fused_gate(gate_fn=None, live=False, pod=None):
    """The divergence gate as its own function, ``gate(params, sync_ref,
    delta[, live_row]) -> (div, do_sync)``: the Kamp divergence of the
    locals from the last synced model (0-d f32; with ``live`` over the
    live rows only) and ``gate_fn(div, delta)`` (the policy's
    ``traced_should_sync``, default ``div > delta``; a 0-d bool). Every
    input is a device tensor (``delta`` 0-d f32), so one captured graph
    serves every threshold and live set. The fused runner replays it
    between the epochs and the finalize: a CUDA graph cannot branch on
    ``do_sync``. ``pod`` (a ``collectives.PodAxis``): the rows are the
    rank's, the liveness row whole, and the drift's sum runs over every
    rank (one scalar all-reduce), so every rank takes the same decision."""
    gate_fn = gate_fn or _default_gate

    @torch.no_grad()
    def gate(params, sync_ref, delta, live_row=None):
        if live and live_row is None:
            raise ValueError("the live gate takes the (K,) liveness row")
        if pod is None:
            div = divergence_tensor(params, sync_ref, live_row)
        else:
            # the sum over the drifts of every rank's rows: one all-reduce
            num, den = divergence_sums(params, sync_ref, pod.local(live_row))
            n = (pod.size if live_row is None
                 else torch.clamp(live_row.float().sum(), min=1.0))
            div = (torch.sqrt(pod.all_reduce_scalar(num) / n)
                   / torch.clamp(torch.sqrt(den), min=1e-12))
        return div, gate_fn(div, delta)
    return gate


def _capturing():
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _make_gated_finalize(opt, aggregate_fn, gate_fn=None, live=False,
                         stateful=False):
    """Divergence-gated finalize, ``gfinalize(params, opt_state, residual,
    sync_ref, delta, [live_row,] agg_weights=None) -> (params, opt_state,
    rel, div, do_sync, new_ref, residual)``: the gate, then on a synced
    round the finalize of ``_make_finalize`` with ``sync_ref`` as the last
    shared model (aggregate, Eq. 4 against it, the new model written into
    it, optimizer reset, residual). A quiet round runs none of it: params,
    optimizer state, residual and reference carry through unchanged and
    ``rel`` is the divergence. ``live``: the divergence runs over the live
    rows and the synced finalize is the live one.

    The reference branches on the device (``lax.cond``); here the branch
    reads ``do_sync`` on the host, so this form runs uncaptured only (the
    CPU, eager card runs). The fused runner splits the round at the gate
    instead (``make_fused_gate``, then the finalize graph)."""
    gate = make_fused_gate(gate_fn, live=live,
                           pod=getattr(aggregate_fn, "pod", None))
    finalize = _make_finalize(opt, aggregate_fn, live=live,
                              stateful=stateful)

    def gfinalize(params, opt_state, residual, sync_ref, delta, *rest):
        if _capturing():
            raise RuntimeError(
                "the gated finalize branches on the host; capture the gate "
                "(make_fused_gate) and the finalize apart")
        live_in = rest[:1] if live else ()
        agg_weights = (rest[len(live_in):] or (None,))[0]
        div, do_sync = gate(params, sync_ref, delta, *live_in)
        rel = div
        # tracelint: disable=TL002 -- refuses capture above: uncaptured only
        if bool(do_sync):
            res_in = (residual,) if stateful else ()
            rel = finalize(params, opt_state, *res_in, sync_ref, *live_in,
                           agg_weights)[2]
        return params, opt_state, rel, div, do_sync, sync_ref, residual
    return gfinalize


def _bind_mask_live(body, masked, live, stateful=False):
    """Adapt ``body(params, opt, residual, batches, mask, live_row,
    *rest)`` to the public signature (the reference's order): the
    residual follows ``opt_state`` when ``stateful`` (bound to None
    otherwise), the mask and then the liveness row follow ``batches`` when
    ``masked`` / ``live`` (bound to None otherwise)."""
    def bound(params, opt_state, residual, batches, *rest):
        mask, rest = (rest[0], rest[1:]) if masked else (None, rest)
        live_row, rest = (rest[0], rest[1:]) if live else (None, rest)
        return body(params, opt_state, residual, batches, mask, live_row,
                    *rest)
    if stateful:
        return bound

    def fn(params, opt_state, batches, *rest):
        return bound(params, opt_state, None, batches, *rest)
    return fn


def make_fused_round(loss_fn, opt, *, lr_fn=None, compress_fn=None,
                     spmd_axis_name=None, average_fn=None, aggregate_fn=None,
                     gated=False, gate_fn=None, masked=False, live=False,
                     stateful=False, marks=None):
    """The whole round: epoch loop + aggregation + Eq. 4.

    ``loss_fn(params, batch) -> (loss, aux)`` for ONE participant; ``opt``
    an optimizer from ``repro_torch.optim.optimizers``; ``lr_fn(sched, j,
    T_i, ge, total)`` the device schedule (default ``schedule.switch_lr``,
    which every built-in ``api.LRSchedule`` shares); ``aggregate_fn(
    stacked, weights)`` the round-strategy aggregation (or the legacy
    ``compress_fn`` / ``average_fn`` pair).

    Returns ``round_fn(params, opt_state, batches, old_avg, ge0, sched,
    total, agg_weights=None) -> (params, opt_state, aux)`` with aux =
    {losses (T, K), lrs (T,), rel (0-d), new_avg}. ``batches`` is a
    ``(T_i, K, n_batches, ...)`` tree (T_i is read off its shape);
    ``ge0`` / ``total`` are 0-d int32 device tensors and ``sched`` the
    device parameter pack. Params, optimizer state and ``old_avg`` are
    written in place (see ``_make_finalize``). ``stateful=True``: the
    round state (any tree) follows ``opt_state`` and aux grows
    ``{"residual"}``.

    ``masked=True`` (ragged shards): the ``(K, n_batches)`` bool device
    mask follows ``batches`` (``make_epoch_fn(masked=True)``).
    ``live=True`` (elastic membership): the ``(K,)`` f32 liveness row
    follows (after the mask): dead rows are identity carries through the
    epochs and the finalize, and the new shared model is the first live
    row.

    ``gated=True`` (``api.DivergenceTrigger``): ``round_fn(params,
    opt_state, [residual,] batches, [mask,] [live_row,] ge0, sched, total,
    sync_ref, delta, agg_weights=None)``, the reference's argument order;
    aux grows {div, synced} and a quiet round keeps the local params and
    optimizer state and ``new_avg`` is ``sync_ref``
    (``_make_gated_finalize``: it branches on the host, so this form is
    not captured — the fused runner splits a gated round at the gate).

    ``spmd_axis_name="pod"`` (the pod path; ``aggregate_fn`` must be built
    against that mesh axis): every tree, the batches and the mask are the
    rank's ``(1, ...)`` slice, the liveness row and the mixing matrix the
    whole ``(K,)`` / ``(K, K)``; aux["losses"] is the whole ``(C, K)``, and
    ``new_avg`` (in ``old_avg``'s storage on every rank) the first live
    rank's row. The collectives make this form eager.

    ``marks`` (ungated): ``spans.marks``' three events, recorded at the
    round's start, after the epochs and after the finalize; captured into
    the round's graph, every replay records them (``spans.between`` reads
    the epochs / finalize split)."""
    scan_epochs = _make_epoch_scan(make_epoch_fn(loss_fn, opt, masked=masked,
                                                 live=live),
                                   lr_fn or switch_lr)
    agg = as_aggregate_fn(aggregate_fn, compress_fn, average_fn)
    pod = _pod_of(agg, spmd_axis_name)

    def epochs_from_zero(params, opt_state, batches, mask, live_row, ge0,
                         sched, total):
        dev = ge0.device
        T_i = torch.full((), leaves(batches)[0].shape[0], dtype=torch.int32,
                         device=dev)
        j0 = torch.zeros((), dtype=torch.int32, device=dev)
        own = live_row if pod is None else pod.local(live_row)
        (params, opt_state), (losses, lrs) = scan_epochs(
            params, opt_state, batches, j0, T_i, ge0, sched, total, mask, own)
        if pod is not None:
            losses = pod.gather_columns(losses)
        return (params, opt_state), (losses, lrs)

    def live_args(live_row):
        return (live_row,) if live else ()

    if gated:
        gfinalize = _make_gated_finalize(opt, agg, gate_fn, live=live,
                                         stateful=stateful)

        def round_body(params, opt_state, residual, batches, mask, live_row,
                       ge0, sched, total, sync_ref, delta, agg_weights=None):
            (params, opt_state), (losses, lrs) = epochs_from_zero(
                params, opt_state, batches, mask, live_row, ge0, sched,
                total)
            out = gfinalize(params, opt_state, residual, sync_ref, delta,
                            *live_args(live_row), agg_weights)
            aux = {"losses": losses, "lrs": lrs, "rel": out[2],
                   "div": out[3], "synced": out[4], "new_avg": out[5]}
            if stateful:
                aux["residual"] = out[6]
            return out[0], out[1], aux
        return _bind_mask_live(round_body, masked, live, stateful)

    finalize = _make_finalize(opt, agg, live=live, stateful=stateful)

    def round_body(params, opt_state, residual, batches, mask, live_row,
                   old_avg, ge0, sched, total, agg_weights=None):
        spans.record(marks, 0)
        (params, opt_state), (losses, lrs) = epochs_from_zero(
            params, opt_state, batches, mask, live_row, ge0, sched, total)
        spans.record(marks, 1)
        res_in = (residual,) if stateful else ()
        out = finalize(params, opt_state, *res_in, old_avg,
                       *live_args(live_row), agg_weights)
        spans.record(marks, 2)
        aux = {"losses": losses, "lrs": lrs, "rel": out[2],
               "new_avg": out[3]}
        if stateful:
            aux["residual"] = out[4]
        return out[0], out[1], aux
    return _bind_mask_live(round_body, masked, live, stateful)


def make_fused_epochs(loss_fn, opt, *, lr_fn=None, spmd_axis_name=None,
                      masked=False, live=False):
    """Memory-bounded building block: ONE CHUNK of epochs.

    Returns ``epochs_fn(params, opt_state, batches, [mask,] [live_row,]
    j0, T_i, ge0, sched, total) -> (params, opt_state, losses (C, K), lrs
    (C,))``, params and optimizer state updated in place. ``j0`` / ``T_i``
    / ``ge0`` / ``total`` / ``sched`` (and the ragged-shard ``mask`` with
    ``masked``, the liveness row with ``live``) are device tensors, so one
    captured graph serves every chunk, every T_i doubling, budget update,
    built-in schedule swap, mask value and live set; only a distinct chunk
    length C captures again.

    ``spmd_axis_name="pod"``: the rank's ``(1, ...)`` rows, its own ``(1,
    n_batches)`` mask and ``(1,)`` liveness entry; the losses are its
    ``(C, 1)`` column (``make_epoch_fn``)."""
    del spmd_axis_name
    scan_epochs = _make_epoch_scan(make_epoch_fn(loss_fn, opt, masked=masked,
                                                 live=live),
                                   lr_fn or switch_lr)

    def epochs_body(params, opt_state, _residual, batches, mask, live_row,
                    j0, T_i, ge0, sched, total):
        (params, opt_state), (losses, lrs) = scan_epochs(
            params, opt_state, batches, j0, T_i, ge0, sched, total, mask,
            live_row)
        return params, opt_state, losses, lrs
    return _bind_mask_live(epochs_body, masked, live)


def make_fused_finalize(opt, *, compress_fn=None, average_fn=None,
                        aggregate_fn=None, gated=False, gate_fn=None,
                        live=False, stateful=False):
    """End-of-round step for the chunked path: aggregation + Eq. 4 + opt
    reset, ``finalize_fn(params, opt_state, [residual,] old_avg,
    [live_row,] agg_weights=None) -> (params, opt_state, rel, new_avg[,
    residual])``, all written in place (``_make_finalize``).

    ``gated=True``: ``finalize_fn(params, opt_state, [residual,] sync_ref,
    delta, [live_row,] agg_weights=None) -> (params, opt_state, rel, div,
    synced, new_ref[, residual])``, the gated select of
    ``_make_gated_finalize`` (uncaptured only).

    An aggregate built against a mesh (``aggregate_fn.pod``) makes it the
    pod finalize: eager, the liveness row and the mixing matrix whole,
    everything else the rank's slice (``_pod_finish``)."""
    agg = as_aggregate_fn(aggregate_fn, compress_fn, average_fn)
    if not gated:
        return _make_finalize(opt, agg, live=live, stateful=stateful)
    gfinalize = _make_gated_finalize(opt, agg, gate_fn, live=live,
                                     stateful=stateful)
    if stateful:
        return gfinalize

    def gfinalize_static(params, opt_state, sync_ref, delta, *rest):
        return gfinalize(params, opt_state, None, sync_ref, delta,
                         *rest)[:6]
    return gfinalize_static


def make_fused_compressed_average(*, block=256, bits=8, mesh=None,
                                  axis="pod", weighted=False,
                                  stateful=False):
    """Eq. 2 fast path: quantized wire emulation + averaging as ONE pass.

    Returns ``average(stacked)`` (uniform), ``average_w(stacked, wrow)``
    (example-count-weighted, via K1/K2 and one einsum) or, with
    ``stateful=True``, the error-feedback forms taking the ``(K, N_pad)``
    residual last and returning ``(stacked, new_residual)``. The mean is
    written into ``stacked`` in place: into every slot, or with ``live=``
    (a ``(K,)`` liveness row) into the live ones only.

    ``mesh`` (the pod path, a ``DeviceMesh`` with an ``axis`` dim): the
    same four signatures over the rank's ``(1, ...)`` tree and ``(1,
    N_pad)`` residual, with the weight row and ``live`` whole
    (``_pod_compressed_average``)."""
    if mesh is not None:
        return _pod_compressed_average(PodAxis(mesh, axis), block=block,
                                       bits=bits, weighted=weighted,
                                       stateful=stateful)

    def _flat(stacked):
        layout = flatbuf.make_layout(stacked, block=block)
        return layout, flatbuf.flatten(stacked, layout)

    def _weighted_mean(y, wrow):
        q, scale, shape = kops.quantize_blockwise(y, block=block, bits=bits)
        dq = kops.dequantize_blockwise(q, scale, shape, bits=bits)
        return torch.einsum("k,kn->n", wrow.float(), dq), dq

    if stateful and weighted:
        @torch.no_grad()
        def average_w_ef(stacked, wrow, residual, live=None):
            layout, buf = _flat(stacked)
            y = buf.add_(residual)
            mean, dq = _weighted_mean(y, wrow)
            return (flatbuf.unflatten_mean(mean, layout, out=stacked,
                                           live=live),
                    y.sub_(dq))
        return average_w_ef

    if stateful:
        @torch.no_grad()
        def average_ef(stacked, residual, live=None):
            layout, buf = _flat(stacked)
            mean, new_res = kops.quant_avg_dequant_ef(buf, residual,
                                                      block=block, bits=bits)
            del buf
            return (flatbuf.unflatten_mean(mean, layout, out=stacked,
                                           live=live),
                    new_res)
        return average_ef

    if weighted:
        @torch.no_grad()
        def average_w(stacked, wrow, live=None):
            layout, buf = _flat(stacked)
            mean, _ = _weighted_mean(buf, wrow)
            return flatbuf.unflatten_mean(mean, layout, out=stacked,
                                          live=live)
        return average_w

    @torch.no_grad()
    def average(stacked, live=None):
        layout, buf = _flat(stacked)
        mean = kops.quant_avg_dequant(buf, block=block, bits=bits)
        del buf
        return flatbuf.unflatten_mean(mean, layout, out=stacked, live=live)
    return average


def check_one_row(stacked, pod, what, weights=None):
    """The pod path mixes whole local rows: exactly one participant row
    per rank, and a weight row or matrix over the pod's K ranks."""
    rows = leaves(stacked)[0].shape[0]
    if rows != 1:
        raise ValueError(
            f"pod-path {what} requires one participant row per pod: the "
            f"local params have {rows} rows")
    if weights is not None and weights.shape[-1] != pod.size:
        raise ValueError(
            f"pod-path {what}: weights over K={weights.shape[-1]} "
            f"participants, the {pod.axis!r} axis has {pod.size} pods")


def _pod_compressed_average(pod, *, block, bits, weighted, stateful):
    """The reference's pod variants (``repro/core/engine.py:366-462``):
    per rank, ``flatbuf.flatten`` of its ``(1, ...)`` tree, K1 over that
    row (plus its residual with error feedback) and the local dequantize
    through K2 (the reference's ``_local_dequant`` computes the same one
    f32 product per value, so the payload is bit-equal), ``w[k]·dq`` where
    weighted, ONE f32 all-reduce of the ``(1, N_pad)`` payload over the
    pods and ``/ K`` where uniform; the new residual ``y − dq`` stays on
    its rank. The wire is the dequantized f32 payload, as the reference's
    psum moves it: ``flatbuf.wire_bytes`` is what an encoded transport
    would carry."""
    K = pod.size

    @torch.no_grad()
    def mean(stacked, wrow, residual, live):
        check_one_row(stacked, pod, "fused mean", wrow)
        layout = flatbuf.make_layout(stacked, block=block)
        y = flatbuf.flatten(stacked, layout)
        if residual is not None:
            y.add_(residual)
        q, scale, shape = kops.quantize_blockwise(y, block=block, bits=bits)
        if residual is None:
            del y
        dq = kops.dequantize_blockwise(q, scale, shape, bits=bits)
        del q, scale
        new_res = None if residual is None else y.sub_(dq)
        if wrow is not None:
            dq.mul_(wrow[pod.index].float())
        pod.all_reduce_([dq])
        if wrow is None:
            dq.div_(torch.full((), float(K), device=dq.device))
        flatbuf.unflatten_mean(dq.reshape(-1), layout, out=stacked,
                               live=pod.local(live))
        return stacked, new_res

    if stateful and weighted:
        def average_w_ef(stacked, wrow, residual, live=None):
            return mean(stacked, wrow, residual, live)
        fn = average_w_ef
    elif stateful:
        def average_ef(stacked, residual, live=None):
            return mean(stacked, None, residual, live)
        fn = average_ef
    elif weighted:
        def average_w(stacked, wrow, live=None):
            return mean(stacked, wrow, None, live)[0]
        fn = average_w
    else:
        def average(stacked, live=None):
            return mean(stacked, None, None, live)[0]
        fn = average
    fn.pod = pod
    return fn
