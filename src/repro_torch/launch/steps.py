"""Step functions and shape helpers, ported from
``repro/launch/steps.py``.

The local training steps (``make_train_step``, its co-learning form
``make_colearn_train_step``), Eq. 2 as a step (``make_average_step``),
the fused round as one step over the simulation path or the pod path
(``make_fused_round_step``), the prefill step (the JAX package's entry to
the flash attention, selective scan and mLSTM kernels:
``make_prefill_step(cfg, impl="kernel")`` runs every attention layer
through K5, every Mamba layer through K6, every mLSTM layer through K7
and every sLSTM layer through the captured recurrence) and the serve
step, one token through ``transformer.decode_step`` (the step
``ServeLoop`` captures). The training steps take the reference's
``remat=True``: each repeat of each segment is recomputed in the backward
pass (``transformer.forward``).

The shape helpers (``config_for_shape``, ``params_shapes``,
``cache_shapes``, ``input_specs``) build their trees on the ``meta``
device, where the reference uses ``jax.eval_shape``: shapes and dtypes,
nothing allocated. ``launch/analytic.py`` counts on them.

The reference's ``lowering`` (a JAX scan lowering) and ``compress_impl``
(the Pallas or plain wire: the port's kernels dispatch on the tensor's
device) have no counterpart.

``long_500k`` policy (the reference's): SSM and hybrid archs run
natively, as does DeepSeek's MLA (its latent cache is the compression);
pure full-attention dense, vlm and audio archs switch to the
sliding-window variant (window 4096).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs.base import InputShape
from repro_torch.core.collectives import PodAxis, axis_sizes, plain
from repro_torch.models import transformer as tr
from repro_torch.optim.optimizers import apply_updates, get_optimizer
from repro_torch.sharding.constrain import batch_axes, constrain, mesh_scope
from repro_torch.tree import leaves, tree_map, unflatten_like

LONG_WINDOW = 4096
# families whose long-context decode needs the SWA carve-in
SWA_AT_500K = {"dense", "vlm", "audio"}
META = torch.device("meta")


def config_for_shape(cfg, shape: InputShape):
    """Apply per-shape config adjustments (the SWA carve-in)."""
    if shape.name == "long_500k" and cfg.family in SWA_AT_500K:
        return cfg.with_(window=LONG_WINDOW)
    return cfg


def params_shapes(cfg, dtype=torch.bfloat16):
    """The params tree on ``meta``: every leaf's shape and dtype, nothing
    drawn or allocated."""
    return tr.init_params(0, cfg, dtype, device=META)


def cache_shapes(cfg, batch, seq_len, dtype=torch.bfloat16):
    """``transformer.init_cache`` on ``meta``."""
    return tr.init_cache(cfg, batch, seq_len, dtype, device=META)


def input_specs(cfg, shape: InputShape, participants: int = 0,
                dtype=torch.bfloat16):
    """Meta-tensor stand-ins for the step's data inputs.

    train/prefill -> the batch dict (``tokens``, ``labels``, and
    ``prefix`` for a ``tokens+prefix`` config); decode -> ``{"cache",
    "token", "pos"}``. ``participants > 0`` stacks a leading K dim (the
    co-learning variant) and splits the global batch over it."""
    B, S = shape.global_batch, shape.seq_len
    lead = (participants,) if participants else ()
    if participants:
        if B % participants:
            raise ValueError(f"global batch {B} does not split over "
                             f"{participants} participants")
        B = B // participants

    def spec(shape_, dtype_):
        return torch.empty(shape_, dtype=dtype_, device=META)

    if shape.kind in ("train", "prefill"):
        prefix = cfg.prefix_len if cfg.input_mode == "tokens+prefix" else 0
        batch = {"tokens": spec((*lead, B, S - prefix), torch.int32),
                 "labels": spec((*lead, B, S), torch.int32)}
        if cfg.input_mode == "tokens+prefix":
            batch["prefix"] = spec((*lead, B, cfg.prefix_len, cfg.d_model),
                                   dtype)
        return batch

    cache = cache_shapes(cfg, B, S, dtype)
    if participants:
        cache = tree_map(lambda v: spec((participants, *v.shape), v.dtype),
                         cache)
    return {"cache": cache, "token": spec((*lead, B, 1), torch.int32),
            "pos": spec((), torch.int32)}


def make_train_step(cfg, optimizer="sgd", lr=0.01, impl="ref", remat=True,
                    microbatch=1, mesh=None):
    """Paper-faithful local step: SGD on the LM loss, ``(params, batch) ->
    (new params, loss)``. ``remat`` recomputes each repeat in the backward
    pass (``transformer.forward``). ``microbatch > 1`` accumulates the f32
    gradients of that many slices of the batch and averages them (the
    same SGD step, a slice's activations at a time).

    On a mesh the params and the batch are DTensors placed by
    ``sharding/specs.py`` (``param_specs`` / ``batch_specs``, through
    ``specs.distribute``): the step runs as one DTensor program, each
    gradient laid out as its param (the reduce-scatter or all-reduce of
    the data-parallel step), and the loss comes back whole on every rank.
    Take ``impl="ref"`` there: a DTensor that reaches a kernel raises.
    ``mesh`` with a ``pod`` axis (the batch over ``("pod", "data")``, the
    params replicated over the pods): each pod runs the step on its rows
    and the gradients and the loss are averaged over the pods (one f32
    all-reduce over the pod group, ``collectives.PodAxis``), the
    data-parallel mean over pods of equal batches. Each pod's loss is the
    mean over its own valid labels and an MoE's load-balance loss is each
    pod's own, so pods whose valid-label counts differ weigh alike."""
    opt = get_optimizer(optimizer)
    pod = (PodAxis(mesh, "pod") if mesh is not None
           and axis_sizes(mesh).get("pod", 1) > 1 else None)

    def grad_of(params, b):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = tr.loss_fn(p, cfg, b, impl, remat)
        grads = [_placed_like(g, t) for g, t in
                 zip(torch.autograd.grad(loss, leaves(p)), leaves(p))]
        return loss.detach(), unflatten_like(p, grads)

    def train_step(params, batch):
        with mesh_scope(params, batch):
            new, loss = step(params, batch)
        return new, plain(loss)

    def step(params, batch):
        if microbatch > 1:
            # slice i is rows [i B/m, (i+1) B/m), each slice over the
            # batch axes (on a mesh the batch is gathered once and each
            # rank keeps its rows of every slice)
            mb = tree_map(lambda t: constrain(
                constrain(t, ("r",) + (None,) * (t.ndim - 1)).reshape(
                    microbatch, t.shape[0] // microbatch, *t.shape[1:]),
                (None, "dp") + (None,) * (t.ndim - 1)), batch)
            grads = tree_map(lambda t: torch.zeros_like(
                t, dtype=torch.float32), params)
            losses = []
            for i in range(microbatch):
                loss, gi = grad_of(params, tree_map(lambda t, _i=i: t[_i],
                                                    mb))
                with torch.no_grad():
                    for g, x in zip(leaves(grads), leaves(gi)):
                        g.add_(x.float())
                losses.append(loss)
            n = torch.full((), float(microbatch), device=loss.device)
            grads = tree_map(lambda g: g / n, grads)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = grad_of(params, batch)
        if pod is not None:
            g, loss = _pod_mean(pod, leaves(grads), loss)
            grads = unflatten_like(grads, g)
        with torch.no_grad():
            upd, _ = opt.update(grads, opt.init(params), params, lr)
            return apply_updates(params, upd), loss

    return train_step


def make_colearn_train_step(cfg, **kw):
    """One local step for every participant row of a stacked tree: all K
    in the simulation, the rank's own ``(1, ...)`` row on the pod path
    (``averaging.participant_step``); no reduction crosses rows. The rows
    carry the pod axis, so the model's "dp" hints resolve to ``data``
    only (``batch_axes``), as in the reference."""
    from repro_torch.core.averaging import participant_step
    step = participant_step(make_train_step(cfg, **kw))

    def wrapped(params, batch):
        with batch_axes(("data",)):
            return step(params, batch)
    return wrapped


@torch.no_grad()
def _pod_mean(pod, grads, loss):
    """The gradients (f32) and the loss averaged over the pods."""
    sums = [g.float() for g in grads]
    sums = [s.clone() if s is g else s for s, g in zip(sums, grads)]
    pod.all_reduce_(sums, op="grad_mean")
    K = torch.full((), float(pod.size), device=plain(loss).device)
    return ([torch.div(s, K).to(g.dtype) for s, g in zip(sums, grads)],
            pod.all_reduce_scalar(loss) / K)


def _placed_like(g, p):
    """Gradient ``g`` laid out as its param ``p`` (a DTensor's gradient
    may come back pending a sum over the data axis)."""
    if g is None or not hasattr(p, "placements") or \
            tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def make_average_step():
    """Eq. 2 over the leading participant dim (``average_pjit``)."""
    from repro_torch.core.averaging import average_pjit
    return average_pjit


def make_fused_round_step(cfg, ccfg, *, optimizer="sgd", impl="ref",
                          remat=True, mesh=None, param_specs=None,
                          codec=None, aggregator=None, schedule=None,
                          round_index=0,
                          expose_schedule_args=False, masked=False,
                          live=False, compress=None, compress_block=256,
                          codec_bits=8, error_feedback=False, device=None):
    """The communication round as one step, on the simulation path
    (``mesh=None``: every tree stacked ``(K, ...)`` on ``device``) or the
    pod path (``mesh``: a ``DeviceMesh`` with a ``pod`` axis, one process
    per participant, every tree the rank's ``(1, ...)`` slice, on the
    mesh's device type).

    ``remat`` recomputes each repeat of the model in the backward pass
    (``transformer.forward``), captured with the epochs.
    ``codec`` / ``aggregator`` / ``schedule`` take ``core/api.py``
    strategy objects or registry names (``schedule=None`` resolves
    ``ccfg.schedule``); ``compress=None|"leafwise"|"fused"`` is the legacy
    spelling of the codec (exclusive with ``codec=``); ``codec_bits`` ∈
    {8, 4, 1} and ``error_feedback`` parameterise the quantising codecs.
    The aggregate is ``aggregator.make_aggregate_fn(codec, mesh=mesh,
    param_specs=param_specs, dynamic=live)``.

    Returns ``round_fn(params, opt_state, [residual,] batches,
    [batch_mask,] [live_row,] ge0[, sched, total][, agg_weights]) ->
    (params, opt_state, aux)``, the reference's signature: ``residual``
    when the codec or the aggregator is stateful
    (``aggregator.init_round_state(codec, params)`` builds it),
    ``batch_mask`` with ``masked`` (the rows' ``(rows, n_batches)`` bool
    mask), ``live_row`` with ``live`` (the WHOLE ``(K,)`` f32 liveness
    row), ``sched`` / ``total`` with ``expose_schedule_args`` (the
    schedule's device pack for the round and the epoch budget; otherwise
    the pack of ``round_index`` and ``T0 · max_rounds`` are baked in), and
    ``agg_weights`` (the whole ``(K, K)`` matrix) for an aggregator that
    uses weights. ``batches`` is the rows' ``(T_i, rows, n_batches, ...)``
    batch dict; ``ge0`` the global epoch at round start. Params,
    optimizer state and residual are updated in place. aux = {losses (T_i,
    K) — every participant's, on the pod too —, lrs (T_i,), rel (0-d),
    new_avg (the first live row: every rank receives it), residual}.

    The round reads the shared model it starts from off the first live
    row, as the reference does (on the pod only that rank copies it: it
    measures Eq. 4 and broadcasts the new model). The epochs are captured
    once on the card (``core/graphs.py``, replayed under the round's sync
    guard; the scalars live in the step's static buffers and the batches,
    mask and liveness entry are copied in) and the finalize runs eagerly:
    a gloo collective goes through the host and cannot be recorded in a
    CUDA graph. ``round_fn.graphs`` is the step's ``GraphSet`` and
    ``round_fn.aggregate`` its aggregate (``.pod.stats`` on the pod).
    While tracing is on (``repro_torch.spans``) and on the card, aux
    carries the round's ``epochs_ms`` and ``finalize_ms`` (device ms,
    from ``spans.marks``' three events, the same fields as
    ``RoundLog``'s; reading them waits for the round's end), None
    otherwise.

    On a mesh with intra-pod axes (``("pod", "data", "model")`` with
    ``data`` or ``model`` > 1) a rank's rows, batches and round state are
    DTensors over its pod's other axes (``specs.distribute(stacked,
    specs.param_specs(stacked, cfg, mesh, participant=True), mesh)``
    keeps the pod's row); the model's "dp"
    hints resolve to ``data`` (``batch_axes``, as in the reference). The
    epochs are then NOT captured: DTensor's collectives inside a pod run
    inside them, and over gloo they go through the host, which a CUDA
    graph cannot record. They run eagerly, with the round's sync guard
    lifted (``allow_sync``) for those host round trips; the aggregate
    runs on the local shards (exact codec) or on the pod's gathered rows
    (quantising codecs), see ``api._intra_pod``."""
    from repro_torch.core import api, engine as eng
    from repro_torch.core.graphs import GraphSet, allow_sync
    from repro_torch.device import resolve_device

    def loss_fn(params, batch):
        return tr.loss_fn(params, cfg, batch, impl, remat)

    if compress is not None:
        if codec is not None:
            raise ValueError("pass codec= or the legacy compress=, not both")
        if compress not in ("leafwise", "fused"):
            raise ValueError(f"unknown compress {compress!r}")
        codec = compress
    codec = api.get_codec(codec, block=compress_block, bits=codec_bits,
                          error_feedback=error_feedback)
    aggregator = api.get_aggregator(aggregator)
    stateful = (getattr(codec, "stateful", False)
                or getattr(aggregator, "stateful", False))
    schedule = api.get_schedule(schedule, ccfg)
    agg = aggregator.make_aggregate_fn(codec, mesh=mesh,
                                       param_specs=param_specs, dynamic=live)
    pod = getattr(agg, "pod", None)
    dev = (torch.device(mesh.device_type) if mesh is not None
           else resolve_device(device))
    opt = get_optimizer(optimizer)
    lr_fn = api.traced_body(schedule)
    epochs = eng.make_fused_epochs(
        loss_fn, opt, lr_fn=lr_fn, masked=masked, live=live,
        spmd_axis_name=None if pod is None else pod.axis)
    finalize = eng.make_fused_finalize(opt, aggregate_fn=agg, live=live,
                                       stateful=stateful)
    graphs = GraphSet(dev)
    marks = spans.marks(dev)
    copied = tuple(range(2, 3 + int(masked) + int(live)))
    intra = mesh is not None and any(
        s > 1 for n, s in axis_sizes(mesh).items() if n != pod.axis)
    if intra:
        def run_epochs(*a):
            return epochs(*a)[2:]
    else:
        run_epochs = graphs.capture(lambda *a: epochs(*a)[2:], "epochs",
                                    inputs=copied, own_inputs=True)

    def scalar(dtype, shape=()):
        return torch.zeros(shape, dtype=dtype, device=dev)
    j0, T, ge0_buf, total_buf = (scalar(torch.int32) for _ in range(4))
    sched_buf = {"kind": scalar(torch.int32),
                 "p": scalar(torch.float32, (api.N_SCHED_PARAMS,))}
    baked = (None if expose_schedule_args else
             (schedule.device_round_params(round_index, dev),
              max(ccfg.T0 * ccfg.max_rounds, 1)))

    def staged(x):
        return x if isinstance(x, torch.Tensor) else eng.stage(x, np.int32,
                                                               dev)

    def round_fn(params, opt_state, *rest):
        with batch_axes(("data",)), mesh_scope(params):
            return one_round(params, opt_state, *rest)

    def one_round(params, opt_state, *rest):
        rest = list(rest)
        residual = rest.pop(0) if stateful else None
        batches = rest.pop(0)
        mask = (rest.pop(0),) if masked else ()
        live_row = rest.pop(0) if live else None
        ge0 = staged(rest.pop(0))
        if baked is None:
            sched, total = rest.pop(0), staged(rest.pop(0))
        else:
            sched, total = baked[0], staged(baked[1])
        agg_w = rest.pop(0) if rest else None
        if rest:
            raise TypeError(f"round_fn got {len(rest)} extra arguments")
        T_i = staged(leaves(batches)[0].shape[0])
        if pod is None:
            old_avg = (eng.unstack_first_live(params, live_row) if live
                       else tree_map(lambda t: t[0].clone(), params))
            own = live_row
        else:
            first = pod.index == pod.first_live(live_row)
            old_avg = tree_map(lambda t: t[0].clone() if first
                               else torch.empty_like(t[0]), params)
            own = pod.local(live_row)
        timed = marks if spans.enabled() else None
        spans.record(timed, 0)
        with (allow_sync() if intra else graphs.no_sync()):
            for buf, x in ((ge0_buf, ge0), (total_buf, total), (T, T_i)):
                buf.copy_(x)
            sched_buf["kind"].copy_(sched["kind"])
            sched_buf["p"].copy_(sched["p"])
            losses, lrs = run_epochs(
                params, opt_state, batches, *mask,
                *((own,) if live else ()), j0, T, ge0_buf, sched_buf,
                total_buf)
            losses, lrs = losses.clone(), lrs.clone()
            spans.record(timed, 1)
        if pod is not None:
            losses = pod.gather_columns(losses)
        out = finalize(params, opt_state, *((residual,) if stateful else ()),
                       old_avg, *((live_row,) if live else ()), agg_w)
        spans.record(timed, 2)
        split = (None, None)
        if timed is not None:
            timed[2].synchronize()
            split = spans.between(timed)
        aux = {"losses": losses, "lrs": lrs, "rel": out[2],
               "new_avg": out[3], "epochs_ms": split[0],
               "finalize_ms": split[1]}
        if stateful:
            aux["residual"] = out[4]
        return out[0], out[1], aux

    round_fn.graphs, round_fn.aggregate = graphs, agg
    return round_fn


def make_prefill_step(cfg, impl="ref"):
    """``prefill_step(params, batch)`` -> last-position logits (B, V). On
    a mesh (DTensor params and batch) the logits are a DTensor, the vocab
    over ``model``."""
    def prefill_step(params, batch):
        with mesh_scope(params, batch):
            return tr.prefill(params, cfg, batch, impl)
    return prefill_step


def make_serve_step(cfg):
    """``serve_step(params, cache, token, pos)`` -> (logits (B, 1, V),
    cache), the cache updated in place. On a mesh the cache is placed by
    ``specs.cache_specs`` and stays so (each slot write runs on the local
    shard). The reference's ``lowering`` knob picks a JAX scan lowering
    and has no counterpart here."""
    def serve_step(params, cache, token, pos):
        with mesh_scope(params, cache, token):
            return tr.decode_step(params, cfg, cache, token, pos)
    return serve_step
