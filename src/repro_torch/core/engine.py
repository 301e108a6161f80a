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
finalize only on a synced round. The liveness row (``live=``) and the pod
mesh are still to port (ROADMAP.md): asking for them raises
``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import averaging, flatbuf
from repro_torch.core.schedule import (divergence_tensor,
                                       relative_change_tensor, switch_lr)
from repro_torch.kernels import ops as kops
from repro_torch.tree import leaves, tree_map, unflatten_like


def _refuse(**variants):
    for name, on in variants.items():
        if on:
            raise NotImplementedError(
                f"the fused engine's {name} variant not yet ported, see "
                "ROADMAP.md")


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


def init_stacked_opt(opt, stacked):
    """Per-participant optimizer state stacked along K (the counterpart
    of ``jax.vmap(opt.init)``)."""
    K = leaves(stacked)[0].shape[0]
    per = [opt.init(tree_map(lambda t, _k=k: t[_k], stacked))
           for k in range(K)]
    return tree_map(lambda *xs: torch.stack(xs), per[0], *per[1:])


def make_epoch_fn(loss_fn, opt, masked=False):
    """One local epoch for all K participants.

    Returns ``epoch_fn(stacked_params, opt_state, batches, lr[, mask]) ->
    (stacked_params, opt_state, per-participant mean loss (K,))`` where
    ``batches`` is a tree of ``(K, n_batches, ...)`` tensors and ``lr`` a
    python float (the python engine) or a 0-d device tensor (the fused
    engine). Params and optimizer state are updated in place (and
    returned).

    ``masked=True`` is the ragged-shard variant: ``mask`` is a ``(K,
    n_batches)`` bool device tensor marking the slots that hold shard k's
    real batches. Every step computes unconditionally and commits through
    ``torch.where(valid, new, old)`` into the params and every optimizer
    leaf (AdamW's step count too), so a masked step is an exact identity
    carry; its loss is left out of the epoch mean, ``Σ where(valid, loss,
    0) / max(Σ valid, 1)``. (A rate of ``lr·valid`` would not do: ``0·inf``
    is NaN, and momentum and AdamW state would still move.) The mask is
    read on the device, so one captured graph serves every mask value."""
    def epoch_fn(stacked, opt_state, batches, lr, mask=None):
        if masked and mask is None:
            raise ValueError("the masked epoch takes the (K, n_batches) "
                             "batch mask")
        K = leaves(stacked)[0].shape[0]
        n_batches = leaves(batches)[0].shape[1]
        means = []
        for k in range(K):
            slot = tree_map(lambda t, _k=k: t[_k], stacked)
            ostate = tree_map(lambda t, _k=k: t[_k], opt_state)
            step_losses = []
            for b in range(n_batches):
                valid = mask[k, b] if masked else None
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
            if masked:
                means.append(torch.stack(step_losses).sum()
                             / torch.clamp(mask[k].sum(), min=1))
            else:
                means.append(torch.stack(step_losses).mean())
        return stacked, opt_state, torch.stack(means)

    return epoch_fn


def _make_epoch_scan(epoch_fn, lr_fn):
    """scan_epochs(params, opt, batches, j0, T_i, ge0, sched, total,
    mask=None) -> ((params, opt), (losses (C, K), lrs (C,))): run the
    leading-dim epochs of ``batches`` with the rate computed on the device
    by ``lr_fn(sched, j, T_i, ge, total)``; ``mask`` (ragged shards) is
    applied every epoch.

    ``j0`` (round-local offset of the first staged epoch), ``T_i`` (the
    round's cycle denominator), ``ge0`` (global epoch at round start) and
    ``total`` (the run's epoch budget) are 0-d int32 device tensors and
    ``sched`` the schedule's device parameter pack, so one captured chunk
    is replayed unchanged as T_i doubles, as the budget updates and across
    built-in schedule swaps."""
    def scan_epochs(stacked, opt_state, batches, j0, T_i, global_epoch0,
                    sched, total, mask=None):
        losses, lrs = [], []
        for c in range(leaves(batches)[0].shape[0]):
            j = j0 + c
            lr = lr_fn(sched, j, T_i, global_epoch0 + j, total)
            ebatches = tree_map(lambda t, _c=c: t[_c], batches)
            stacked, opt_state, loss = epoch_fn(stacked, opt_state,
                                                ebatches, lr, mask)
            losses.append(loss)
            lrs.append(lr)
        return (stacked, opt_state), (torch.stack(losses), torch.stack(lrs))
    return scan_epochs


def as_aggregate_fn(aggregate_fn=None, compress_fn=None, average_fn=None):
    """Normalize the aggregation surface to ``aggregate(stacked, weights)``.

    ``aggregate_fn`` (from a ``core/api.py`` aggregator) passes through;
    the legacy pair — an optional stacked -> stacked ``compress_fn``
    upload transform followed by a one-argument ``average_fn`` (default
    ``averaging.average_pjit``) — is wrapped, ignoring weights. Passing
    both surfaces is an error."""
    if aggregate_fn is not None:
        if compress_fn is not None or average_fn is not None:
            raise ValueError(
                "pass aggregate_fn OR compress_fn/average_fn, not both")
        return aggregate_fn
    if average_fn is None:
        average_fn = averaging.average_pjit

    def aggregate(stacked, weights=None):
        del weights                     # legacy pair: statically uniform
        uploaded = compress_fn(stacked) if compress_fn is not None else stacked
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


def _make_finalize(opt, aggregate_fn, stateful=False):
    """Aggregation (Eq. 2) + Eq. 4 metric + per-participant opt reset.

    ``finalize(params, opt_state, old_avg, agg_weights=None) -> (params,
    opt_state, rel, new_avg)``. Everything is written in place: the
    aggregate into ``params``, the fresh optimizer state into
    ``opt_state`` (the paper discards the local state), and the new shared
    model (slot 0) into ``old_avg`` after ``rel`` has read it — so
    ``new_avg`` IS ``old_avg``'s storage. ``agg_weights`` is the
    aggregator's mixing matrix (None for uniform Eq. 2).

    ``stateful=True`` (error feedback): the residual enters right after
    ``opt_state``, the aggregate is ``aggregate_fn(params, agg_weights,
    residual) -> (mixed, new_residual)``, the new residual is written into
    ``residual`` and appended to the outputs."""
    @torch.no_grad()
    def finish(params, opt_state, averaged, old_avg):
        _write_into(params, averaged)
        new_avg = tree_map(lambda t: t[0], params)
        rel = relative_change_tensor(new_avg, old_avg)
        _write_into(old_avg, new_avg)
        _write_into(opt_state, init_stacked_opt(opt, params))
        return rel

    if stateful:
        def finalize_ef(params, opt_state, residual, old_avg,
                        agg_weights=None):
            averaged, new_res = aggregate_fn(params, agg_weights, residual)
            rel = finish(params, opt_state, averaged, old_avg)
            return params, opt_state, rel, old_avg, _write_into(residual,
                                                                new_res)
        return finalize_ef

    def finalize(params, opt_state, old_avg, agg_weights=None):
        averaged = aggregate_fn(params, agg_weights)
        rel = finish(params, opt_state, averaged, old_avg)
        return params, opt_state, rel, old_avg
    return finalize


def _default_gate(div, delta):
    """The default device gate (``api.SyncPolicy.traced_should_sync``)."""
    return div > delta


def make_fused_gate(gate_fn=None):
    """The divergence gate as its own function, ``gate(params, sync_ref,
    delta) -> (div, do_sync)``: the Kamp divergence of the locals from the
    last synced model (0-d f32) and ``gate_fn(div, delta)`` (the policy's
    ``traced_should_sync``, default ``div > delta``; a 0-d bool). Every
    input is a device tensor (``delta`` 0-d f32), so one captured graph
    serves every threshold. The fused runner replays it between the
    epochs and the finalize: a CUDA graph cannot branch on ``do_sync``."""
    gate_fn = gate_fn or _default_gate

    @torch.no_grad()
    def gate(params, sync_ref, delta):
        div = divergence_tensor(params, sync_ref)
        return div, gate_fn(div, delta)
    return gate


def _capturing():
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def _make_gated_finalize(opt, aggregate_fn, gate_fn=None, stateful=False):
    """Divergence-gated finalize, ``gfinalize(params, opt_state, residual,
    sync_ref, delta, agg_weights=None) -> (params, opt_state, rel, div,
    do_sync, new_ref, residual)``: the gate, then on a synced round the
    finalize of ``_make_finalize`` with ``sync_ref`` as the last shared
    model (aggregate, Eq. 4 against it, the new model written into it,
    optimizer reset, residual). A quiet round runs none of it: params,
    optimizer state, residual and reference carry through unchanged and
    ``rel`` is the divergence.

    The reference branches on the device (``lax.cond``); here the branch
    reads ``do_sync`` on the host, so this form runs uncaptured only (the
    CPU, eager card runs). The fused runner splits the round at the gate
    instead (``make_fused_gate``, then the finalize graph)."""
    gate = make_fused_gate(gate_fn)
    finalize = _make_finalize(opt, aggregate_fn, stateful=stateful)

    def gfinalize(params, opt_state, residual, sync_ref, delta,
                  agg_weights=None):
        if _capturing():
            raise RuntimeError(
                "the gated finalize branches on the host; capture the gate "
                "(make_fused_gate) and the finalize apart")
        div, do_sync = gate(params, sync_ref, delta)
        rel = div
        if bool(do_sync):
            res_in = (residual,) if stateful else ()
            rel = finalize(params, opt_state, *res_in, sync_ref,
                           agg_weights)[2]
        return params, opt_state, rel, div, do_sync, sync_ref, residual
    return gfinalize


def _bind_mask(body, masked, stateful=False):
    """Adapt ``body(params, opt, residual, batches, mask, *rest)`` to the
    public signature (the order of the reference's ``_bind_mask_live``):
    the residual follows ``opt_state`` when ``stateful`` (bound to None
    otherwise), the mask follows ``batches`` when ``masked`` (bound to
    None otherwise)."""
    if masked:
        bound = body
    else:
        def bound(params, opt_state, residual, batches, *rest):
            return body(params, opt_state, residual, batches, None, *rest)
    if stateful:
        return bound

    def fn(params, opt_state, batches, *rest):
        return bound(params, opt_state, None, batches, *rest)
    return fn


def make_fused_round(loss_fn, opt, *, lr_fn=None, compress_fn=None,
                     spmd_axis_name=None, average_fn=None, aggregate_fn=None,
                     gated=False, gate_fn=None, masked=False, live=False,
                     stateful=False):
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
    residual follows ``opt_state`` and aux grows ``{"residual"}``.

    ``masked=True`` (ragged shards): the ``(K, n_batches)`` bool device
    mask follows ``batches`` (``make_epoch_fn(masked=True)``).

    ``gated=True`` (``api.DivergenceTrigger``): ``round_fn(params,
    opt_state, [residual,] batches, [mask,] ge0, sched, total, sync_ref,
    delta, agg_weights=None)``, the reference's argument order; aux grows
    {div, synced} and a quiet round keeps the local params and optimizer
    state and ``new_avg`` is ``sync_ref`` (``_make_gated_finalize``: it
    branches on the host, so this form is not captured — the fused runner
    splits a gated round at the gate). ``live`` and a pod axis raise
    ``NotImplementedError``."""
    _refuse(live=live, pod=spmd_axis_name is not None)
    scan_epochs = _make_epoch_scan(make_epoch_fn(loss_fn, opt,
                                                 masked=masked),
                                   lr_fn or switch_lr)
    agg = as_aggregate_fn(aggregate_fn, compress_fn, average_fn)

    def epochs_from_zero(params, opt_state, batches, mask, ge0, sched,
                         total):
        dev = ge0.device
        T_i = torch.full((), leaves(batches)[0].shape[0], dtype=torch.int32,
                         device=dev)
        j0 = torch.zeros((), dtype=torch.int32, device=dev)
        return scan_epochs(params, opt_state, batches, j0, T_i, ge0, sched,
                           total, mask)

    if gated:
        gfinalize = _make_gated_finalize(opt, agg, gate_fn,
                                         stateful=stateful)

        def round_body(params, opt_state, residual, batches, mask, ge0,
                       sched, total, sync_ref, delta, agg_weights=None):
            (params, opt_state), (losses, lrs) = epochs_from_zero(
                params, opt_state, batches, mask, ge0, sched, total)
            out = gfinalize(params, opt_state, residual, sync_ref, delta,
                            agg_weights)
            aux = {"losses": losses, "lrs": lrs, "rel": out[2],
                   "div": out[3], "synced": out[4], "new_avg": out[5]}
            if stateful:
                aux["residual"] = out[6]
            return out[0], out[1], aux
        return _bind_mask(round_body, masked, stateful)

    finalize = _make_finalize(opt, agg, stateful=stateful)

    def round_body(params, opt_state, residual, batches, mask, old_avg, ge0,
                   sched, total, agg_weights=None):
        (params, opt_state), (losses, lrs) = epochs_from_zero(
            params, opt_state, batches, mask, ge0, sched, total)
        res_in = (residual,) if stateful else ()
        out = finalize(params, opt_state, *res_in, old_avg, agg_weights)
        aux = {"losses": losses, "lrs": lrs, "rel": out[2],
               "new_avg": out[3]}
        if stateful:
            aux["residual"] = out[4]
        return out[0], out[1], aux
    return _bind_mask(round_body, masked, stateful)


def make_fused_epochs(loss_fn, opt, *, lr_fn=None, spmd_axis_name=None,
                      masked=False, live=False):
    """Memory-bounded building block: ONE CHUNK of epochs.

    Returns ``epochs_fn(params, opt_state, batches, [mask,] j0, T_i, ge0,
    sched, total) -> (params, opt_state, losses (C, K), lrs (C,))``, params
    and optimizer state updated in place. ``j0`` / ``T_i`` / ``ge0`` /
    ``total`` / ``sched`` (and the ragged-shard ``mask`` with ``masked``)
    are device tensors, so one captured graph serves every chunk, every
    T_i doubling, budget update, built-in schedule swap and mask value;
    only a distinct chunk length C captures again."""
    _refuse(live=live, pod=spmd_axis_name is not None)
    scan_epochs = _make_epoch_scan(make_epoch_fn(loss_fn, opt,
                                                 masked=masked),
                                   lr_fn or switch_lr)

    def epochs_body(params, opt_state, _residual, batches, mask, j0, T_i,
                    ge0, sched, total):
        (params, opt_state), (losses, lrs) = scan_epochs(
            params, opt_state, batches, j0, T_i, ge0, sched, total, mask)
        return params, opt_state, losses, lrs
    return _bind_mask(epochs_body, masked)


def make_fused_finalize(opt, *, compress_fn=None, average_fn=None,
                        aggregate_fn=None, gated=False, gate_fn=None,
                        live=False, stateful=False):
    """End-of-round step for the chunked path: aggregation + Eq. 4 + opt
    reset, ``finalize_fn(params, opt_state, [residual,] old_avg,
    agg_weights=None) -> (params, opt_state, rel, new_avg[, residual])``,
    all written in place (``_make_finalize``).

    ``gated=True``: ``finalize_fn(params, opt_state, [residual,] sync_ref,
    delta, agg_weights=None) -> (params, opt_state, rel, div, synced,
    new_ref[, residual])``, the gated select of ``_make_gated_finalize``
    (uncaptured only). ``live`` raises ``NotImplementedError``."""
    _refuse(live=live)
    agg = as_aggregate_fn(aggregate_fn, compress_fn, average_fn)
    if not gated:
        return _make_finalize(opt, agg, stateful=stateful)
    gfinalize = _make_gated_finalize(opt, agg, gate_fn, stateful=stateful)
    if stateful:
        return gfinalize

    def gfinalize_static(params, opt_state, sync_ref, delta,
                         agg_weights=None):
        return gfinalize(params, opt_state, None, sync_ref, delta,
                         agg_weights)[:6]
    return gfinalize_static


def make_fused_compressed_average(*, block=256, bits=8, mesh=None,
                                  axis="pod", weighted=False,
                                  stateful=False):
    """Eq. 2 fast path: quantized wire emulation + averaging as ONE pass.

    Returns ``average(stacked)`` (uniform), ``average_w(stacked, wrow)``
    (example-count-weighted, via K1/K2 and one einsum) or, with
    ``stateful=True``, the error-feedback forms taking the ``(K, N_pad)``
    residual last and returning ``(stacked, new_residual)``. The mean is
    written into ``stacked`` in place. ``mesh`` (the pod path) is still to
    port."""
    if mesh is not None:
        raise NotImplementedError(
            "the pod-mesh wire path is not yet ported, see ROADMAP.md")

    def _flat(stacked):
        layout = flatbuf.make_layout(stacked, block=block)
        return layout, flatbuf.flatten(stacked, layout)

    def _weighted_mean(y, wrow):
        q, scale, shape = kops.quantize_blockwise(y, block=block, bits=bits)
        dq = kops.dequantize_blockwise(q, scale, shape, bits=bits)
        return torch.einsum("k,kn->n", wrow.float(), dq), dq

    if stateful and weighted:
        @torch.no_grad()
        def average_w_ef(stacked, wrow, residual):
            layout, buf = _flat(stacked)
            y = buf.add_(residual)
            mean, dq = _weighted_mean(y, wrow)
            return (flatbuf.unflatten_mean(mean, layout, out=stacked),
                    y.sub_(dq))
        return average_w_ef

    if stateful:
        @torch.no_grad()
        def average_ef(stacked, residual):
            layout, buf = _flat(stacked)
            mean, new_res = kops.quant_avg_dequant_ef(buf, residual,
                                                      block=block, bits=bits)
            del buf
            return (flatbuf.unflatten_mean(mean, layout, out=stacked),
                    new_res)
        return average_ef

    if weighted:
        @torch.no_grad()
        def average_w(stacked, wrow):
            layout, buf = _flat(stacked)
            mean, _ = _weighted_mean(buf, wrow)
            return flatbuf.unflatten_mean(mean, layout, out=stacked)
        return average_w

    @torch.no_grad()
    def average(stacked):
        layout, buf = _flat(stacked)
        mean = kops.quant_avg_dequant(buf, block=block, bits=bits)
        del buf
        return flatbuf.unflatten_mean(mean, layout, out=stacked)
    return average
