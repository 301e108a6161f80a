"""Round-strategy API, ported from ``repro/core/api.py``:
WireCodec x Aggregator x RoundEngine x LRSchedule x SyncPolicy.

Ported here: the codecs :class:`ExactF32`, :class:`LeafwiseIntN` /
:class:`LeafwiseInt8`, :class:`FlatFusedIntN` / :class:`FlatFusedInt8`
(with error feedback) and :class:`CustomFn`; the aggregators
:class:`FullAverage` (uniform Eq. 2 and example-count weights),
:class:`PartialParticipation`, :class:`GraphGossip` over every topology
of ``core/topology.py``, :class:`RingGossip` and :class:`D2Gossip` (whose
correction rides the engines' one round-state slot), each with its
elastic-membership form (``mixing_matrix(live=)``, ``comm_bytes(live=)``,
``make_aggregate_fn(dynamic=True)``); the :class:`PythonEngine`
reference loop and the :class:`FusedEngine` (every round as replays of
CUDA graphs captured once, ``core/graphs.py``; under active churn the
liveness row rides in one static device buffer); the :class:`CLR` /
:class:`ELR` / :class:`WarmupCLR` / :class:`CosineCyclical` schedules and
the :class:`ILE` / :class:`FLE` / :class:`DivergenceTrigger` sync
policies, with the registries and ``get_*`` resolvers.

The pod path (``make_aggregate_fn(codec, mesh=...)``): one process per
participant, each aggregating its ``(1, ...)`` slice over the mesh's
``pod`` group (``core/collectives.py``): the flat codec's fused mean (K1
+ K2 + one all-reduce), the weighted psum (weighted :class:`FullAverage`,
:class:`PartialParticipation`, the uniform error-feedback mean), the
leaf-wise codec's roundtrip in front of ``make_average_shard_map``, and
one point-to-point exchange per ``Topology.edge_perms`` permutation for
the gossip aggregators. Where the reference's hook returns None (a
dynamic, time-varying or irregular graph, a stateful codec under gossip)
it falls back to the dense mix, which under GSPMD gathers every pod's
row; here that is one broadcast from each rank, O(K·model) traffic, and
the built function says so (``aggregate.dense_fallback``). Every pod
aggregate carries its ``PodAxis`` (``aggregate.pod``: its ``stats``
count the wire). The mixing matrix and the liveness row stay whole. On a
mesh with intra-pod axes a row's leaves are DTensors over the pod's
``data`` / ``model`` axes (``_intra_pod``): the exact codec aggregates
the local shards, a quantising codec the pod's gathered row.

Aggregation runs IN PLACE on the stacked params: the exact mean and the
fused flat-buffer mean write into them, and a mixing matrix is applied
leaf by leaf (a per-leaf codec's roundtrip of one leaf, its mix, a copy
back), so at full width no second K-model tree is built beside the K the
participants train. Given a liveness row (``live=``) an aggregate writes
only the live rows.
"""
from __future__ import annotations

import abc
import dataclasses
import functools
import inspect
import math
import weakref
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import averaging, compression, flatbuf
from repro_torch.core import engine as engine_mod
from repro_torch.core import topology as topo_mod
from repro_torch.core.collectives import PodAxis, axis_sizes
from repro_torch.core.graphs import GraphSet, allow_sync
from repro_torch.core.schedule import (LR_COS_ROUND, LR_EXP_GLOBAL,
                                       LR_EXP_ROUND, N_SCHED_PARAMS, clr_lr,
                                       cosine_lr, divergence, elr_lr,
                                       relative_change, switch_lr)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quantize import DEFAULT_BLOCK, check_bits
from repro_torch.tree import leaves, tree_map, unflatten_like


def participant_bytes(stacked) -> int:
    """Raw per-participant bytes of a stacked ``(K, ...)`` params tree at
    its native dtypes — the download side of the accounting."""
    return sum((t.numel() // t.shape[0]) * t.element_size()
               for t in leaves(stacked))


def _one_participant(stacked):
    """Slot 0 views of a stacked tree (shapes of ONE participant)."""
    return tree_map(lambda t: t[0], stacked)


# ---------------------------------------------------------------------------
# WireCodec
# ---------------------------------------------------------------------------
class WireCodec(abc.ABC):
    """What one participant's upload looks like on the wire.

    ``decode(encode(stacked))`` is the in-sim wire emulation;
    ``wire_bytes`` is the exact per-participant upload byte count. A
    stateful codec (error feedback) builds its zero residual with
    ``init_state`` and emulates the wire with ``roundtrip_ef``."""

    name: str = "codec"
    #: True when the encoding is per stacked leaf (``leaf_roundtrip``);
    #: False when blocks span leaves (roundtrip the whole tree)
    per_leaf: bool = False

    @property
    def stateful(self) -> bool:
        return False

    def init_state(self, stacked):
        return None

    def leaf_roundtrip(self, t, e=None):
        """The wire emulation of ONE stacked leaf (``per_leaf`` codecs):
        ``(roundtripped leaf, new residual leaf)``; ``e`` is the leaf's
        error-feedback residual (None without error feedback)."""
        raise NotImplementedError(
            f"codec {self.name!r} encodes the whole tree, not per leaf")

    def roundtrip_ef(self, stacked, residual):
        raise NotImplementedError(
            f"codec {self.name!r} is stateless (no error feedback)")

    @abc.abstractmethod
    def encode(self, stacked):
        """Stacked ``(K, ...)`` params tree -> wire representation."""

    @abc.abstractmethod
    def decode(self, wire):
        """Wire representation -> stacked params tree (original dtypes)."""

    def roundtrip(self, stacked):
        return self.decode(self.encode(stacked))

    @abc.abstractmethod
    def wire_bytes(self, stacked) -> int:
        """Exact bytes ONE participant uploads for this stacked tree."""

    def make_fused_mean(self, mesh=None, axis="pod", weighted=False,
                        stateful=False):
        """Optional codec-owned Eq. 2 fast path; None = the aggregator
        composes ``roundtrip`` with a generic mean."""
        return None


@dataclasses.dataclass(frozen=True)
class ExactF32(WireCodec):
    """The paper-faithful wire: parameters travel at their raw dtypes."""

    name = "exact"
    per_leaf = True

    def leaf_roundtrip(self, t, e=None):
        return t, e

    def encode(self, stacked):
        return stacked

    def decode(self, wire):
        return wire

    def wire_bytes(self, stacked) -> int:
        return participant_bytes(stacked)


@dataclasses.dataclass(frozen=True)
class LeafwiseIntN(WireCodec):
    """Per-leaf blockwise quantization roundtrip at ``bits`` ∈ {8, 4, 1};
    leaves smaller than one ``block`` bypass the codec and are billed at
    raw size. On CUDA tensors every quantized leaf launches K1 and K2."""

    block: int = DEFAULT_BLOCK
    bits: int = 8
    error_feedback: bool = False
    per_leaf = True

    def __post_init__(self):
        check_bits(self.bits)

    @property
    def name(self):
        tag = "leafwise" if self.bits == 8 else f"leafwise-int{self.bits}"
        return tag + "+ef" if self.error_feedback else tag

    @property
    def stateful(self) -> bool:
        return self.error_feedback

    def init_state(self, stacked):
        if not self.error_feedback:
            return None
        return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                              device=t.device), stacked)

    def roundtrip_ef(self, stacked, residual):
        return compression.quantize_roundtrip_ef(
            stacked, residual, block=self.block, bits=self.bits)

    @torch.no_grad()
    def leaf_roundtrip(self, t, e=None):
        """One leaf of ``roundtrip`` (``e`` None) or of ``roundtrip_ef``;
        the leaf's K1 and K2 launch here, and its intermediates die with
        the call."""
        if e is None:
            if t.ndim == 0 or t.numel() < self.block:
                return t, None
            q, scale, shape = kops.quantize_blockwise(t, block=self.block,
                                                      bits=self.bits)
            return kops.dequantize_blockwise(q, scale, shape,
                                             bits=self.bits).to(t.dtype), None
        rt, res = compression.quantize_roundtrip_ef([t], [e],
                                                    block=self.block,
                                                    bits=self.bits)
        return rt[0], res[0]

    def encode(self, stacked):
        enc = []
        for t in leaves(stacked):
            if t.ndim == 0 or t.numel() < self.block:
                enc.append(("raw", t, None))
            else:
                enc.append((f"q{self.bits}", kops.quantize_blockwise(
                    t, block=self.block, bits=self.bits), t.dtype))
        return (stacked, tuple(enc))

    def decode(self, wire):
        like, enc = wire
        out = []
        for kind, payload, dtype in enc:
            if kind == "raw":
                out.append(payload)
            else:
                q, scale, shape = payload
                out.append(kops.dequantize_blockwise(
                    q, scale, shape, bits=self.bits).to(dtype))
        return unflatten_like(like, out)

    def wire_bytes(self, stacked) -> int:
        return compression.compressed_bytes(_one_participant(stacked),
                                            block=self.block, bits=self.bits)


@dataclasses.dataclass(frozen=True)
class LeafwiseInt8(LeafwiseIntN):
    """The int8 point of :class:`LeafwiseIntN` (registry name)."""

    name = "leafwise"


@dataclasses.dataclass(frozen=True)
class FlatFusedIntN(WireCodec):
    """The flat-buffer wire format at ``bits`` ∈ {8, 4, 1}: one contiguous
    ``(K, N_pad)`` buffer, every leaf on the packed-payload + per-block
    scale format. Under :class:`FullAverage` the quantize -> average ->
    dequantize pass is ONE kernel (K3; K4 with ``error_feedback``, whose
    residual is one ``(K, N_pad)`` f32 buffer on the same layout)."""

    block: int = DEFAULT_BLOCK
    bits: int = 8
    error_feedback: bool = False

    def __post_init__(self):
        check_bits(self.bits)

    @property
    def name(self):
        tag = "fused" if self.bits == 8 else f"fused-int{self.bits}"
        return tag + "+ef" if self.error_feedback else tag

    @property
    def stateful(self) -> bool:
        return self.error_feedback

    def init_state(self, stacked):
        if not self.error_feedback:
            return None
        layout = flatbuf.make_layout(stacked, block=self.block)
        return torch.zeros((layout.k, layout.n_pad), dtype=torch.float32,
                           device=leaves(stacked)[0].device)

    # The standalone roundtrip (partial participation): one K1 over the
    # whole (K, N_pad) buffer, one K2 back. Each intermediate is dropped
    # as soon as its consumer has run: at full width every one is K
    # model copies.
    @torch.no_grad()
    def roundtrip_ef(self, stacked, residual):
        layout = flatbuf.make_layout(stacked, block=self.block)
        y = flatbuf.flatten(stacked, layout).add_(residual)
        q, scale, shape = kops.quantize_blockwise(y, block=self.block,
                                                  bits=self.bits)
        dq = kops.dequantize_blockwise(q, scale, shape, bits=self.bits)
        del q, scale
        return flatbuf.unflatten(dq, layout), y.sub_(dq)

    @torch.no_grad()
    def encode(self, stacked):
        layout = flatbuf.make_layout(stacked, block=self.block)
        q, scale, shape = kops.quantize_blockwise(
            flatbuf.flatten(stacked, layout), block=self.block,
            bits=self.bits)
        return (layout, q, scale, shape)

    @torch.no_grad()
    def decode(self, wire):
        layout, q, scale, shape = wire
        return flatbuf.unflatten(kops.dequantize_blockwise(
            q, scale, shape, bits=self.bits), layout)

    def wire_bytes(self, stacked) -> int:
        return compression.flat_compressed_bytes(stacked, block=self.block,
                                                 bits=self.bits)

    def make_fused_mean(self, mesh=None, axis="pod", weighted=False,
                        stateful=False):
        if stateful and not self.error_feedback:
            raise ValueError("stateful fused mean requires error_feedback")
        fused = engine_mod.make_fused_compressed_average(
            block=self.block, bits=self.bits, mesh=mesh, axis=axis,
            weighted=weighted, stateful=stateful)
        return fused if mesh is None else _intra_pod(fused, self)


@dataclasses.dataclass(frozen=True)
class FlatFusedInt8(FlatFusedIntN):
    """The int8 point of :class:`FlatFusedIntN` (registry name)."""

    name = "fused"


@dataclasses.dataclass(frozen=True)
class CustomFn(WireCodec):
    """Escape hatch wrapping an arbitrary stacked -> stacked wire transform
    (the legacy ``CoLearner.from_flags(compress_fn=...)``). The encoding is
    opaque, so ``wire_bytes`` conservatively bills raw-dtype bytes."""

    fn: Callable
    name = "custom"

    def encode(self, stacked):
        return self.fn(stacked)

    def decode(self, wire):
        return wire

    def wire_bytes(self, stacked) -> int:
        return participant_bytes(stacked)


# ---------------------------------------------------------------------------
# Aggregator
# ---------------------------------------------------------------------------
def normalized_weights(weights, K: int) -> np.ndarray:
    """Validate per-participant averaging weights and return them
    normalized to sum 1 as a length-K f64 array."""
    w = np.asarray(weights, np.float64)
    if w.shape != (K,):
        raise ValueError(f"weights must have length K={K}; got {w.shape}")
    if not np.isfinite(w).all() or (w < 0).any():
        raise ValueError(f"weights must be finite and >= 0; got {w}")
    if not w.sum() > 0:
        raise ValueError("weights must not all be zero")
    return w / w.sum()


@torch.no_grad()
def _mix_into(codec, stacked, weights, residual, live, serverless,
              corr=None):
    """Apply a ``(K, K)`` mixing matrix over the codec's wire IN PLACE,
    leaf by leaf; returns ``(stacked, new_residual)``.

    Each leaf is roundtripped (a ``per_leaf`` codec: this leaf alone; a
    flat codec: the whole tree first, since its blocks span leaves), mixed
    into a new tensor of one leaf's size and copied back, into the live
    rows only when ``live`` is given. ``serverless`` (gossip): a row's
    own model does not cross the wire, so the diagonal mixes the exact
    local value and only the off-diagonal leg the roundtrip. ``corr`` (the
    D² correction tree): the value sent is ``v = y + c`` and the new
    correction ``x' − y`` is written into ``corr``. An error-feedback
    residual of a per-leaf codec is updated in place too."""
    M = weights.float()
    if serverless:
        d = torch.diagonal(M)
        M = M - torch.diag(d)
    ef = codec.stateful
    xs = leaves(stacked)
    cs = leaves(corr) if corr is not None else [None] * len(xs)

    def value(t, c):
        return t.float() + c if c is not None else t.float()

    if codec.per_leaf:
        es = leaves(residual) if ef else [None] * len(xs)
        new_res, rts = residual, None
    else:
        sent = (stacked if corr is None else unflatten_like(
            stacked, [value(t, c).to(t.dtype) for t, c in zip(xs, cs)]))
        if ef:
            rt, new_res = codec.roundtrip_ef(sent, residual)
        else:
            rt, new_res = codec.roundtrip(sent), None
        del sent
        rts = leaves(rt)
        del rt
    for i, (t, c) in enumerate(zip(xs, cs)):
        if rts is None:
            sent = t if c is None else value(t, c).to(t.dtype)
            q, e_new = codec.leaf_roundtrip(sent, es[i])
            del sent
            if ef:
                engine_mod.commit(es[i], e_new, live)
            del e_new
        else:
            q, rts[i] = rts[i], None
        mixed = torch.einsum("kj,j...->k...", M, q.float())
        del q
        if serverless:
            d_rows = d.reshape((-1,) + (1,) * (t.ndim - 1))
            mixed = torch.mul(d_rows, value(t, c)).add_(mixed)
        if c is not None:
            engine_mod.commit(c, mixed - t.float(), live)
        engine_mod.commit(t, mixed.to(t.dtype), live)
        del mixed
    return stacked, new_res


def normalized_weights(weights, K: int) -> np.ndarray:
    """Validate per-participant averaging weights and return them
    normalized to sum 1 as a length-K f64 array."""
    w = np.asarray(weights, np.float64)
    if w.shape != (K,):
        raise ValueError(f"weights must have length K={K}; got {w.shape}")
    if not np.isfinite(w).all() or (w < 0).any():
        raise ValueError(f"weights must be finite and >= 0; got {w}")
    if not w.sum() > 0:
        raise ValueError("weights must not all be zero")
    return w / w.sum()


def _own_slice(full, like):
    """This rank's shard of the whole tensor ``full`` in ``like``'s
    placements (a local chunk: nothing crosses the wire)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    whole = DTensor.from_local(full, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, like.placements).to_local()


def _intra_pod(fn, codec):
    """A pod aggregate that also takes rows laid out inside their pod
    (DTensor leaves over the pod's ``data`` / ``model`` axes, on a mesh
    with intra-pod axes). The exact codec runs ``fn`` on the local shards:
    the psums and permutes move each shard over its pod group, as the
    reference's ``shard_map(in_specs=param_specs)`` does. A quantising
    codec forms its blocks over the whole leaf (leaf-wise) or the pod's
    whole flat row (flat), so ``fn`` runs on the rows gathered inside the
    pod (``full_tensor``): K1/K2 and the pod all-reduce as on the
    unsharded path, then each rank keeps its own slice. Plain tensors
    pass through; a tree ``fn`` returns holds the DTensors it was given
    (new tensors, a gathered path's new residual, stay plain)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.core.collectives import local
    exact = isinstance(codec, ExactF32)

    def wrapped(stacked, *rest, **kw):
        pairs = []

        def down(t):
            if not isinstance(t, DTensor):
                return t
            x = local(t) if exact else t.full_tensor()
            pairs.append((t, x))
            return x
        if not any(isinstance(t, DTensor) for t in leaves(stacked)):
            return fn(stacked, *rest, **kw)
        args = [tree_map(down, a) for a in (stacked, *rest)]
        with torch.no_grad():
            out = fn(*args, **kw)
            if not exact:
                for t, x in pairs:
                    local(t).copy_(_own_slice(x, t))
        back = {id(x): t for t, x in pairs}
        return tree_map(lambda o: back.get(id(o), o), out)
    return _carry(fn, wrapped)


def _carry(src, fn):
    """``fn`` wraps pod aggregate ``src``: it carries ``src``'s marks."""
    if hasattr(src, "pod"):
        _on_pod(fn, src.pod, getattr(src, "dense_fallback", False))
    return fn


def _on_pod(fn, pod, dense=False):
    """Mark a pod aggregate: its ``PodAxis`` and whether it is the dense
    fallback."""
    fn.pod, fn.dense_fallback = pod, dense
    return fn


def _check_one_row_per_pod(aggregator, stacked, pod, weights=None):
    """The pod specialisations mix whole local rows, so they are only
    correct with exactly one participant row per rank and a matrix over
    the pod's K: fail loudly instead of mixing the wrong rows."""
    engine_mod.check_one_row(stacked, pod, f"{aggregator.name!r} "
                             "aggregation", weights)


@torch.no_grad()
def _pod_mix_into(pod, codec, stacked, weights, residual, live, serverless,
                  corr=None):
    """``_mix_into`` on the pod path, the dense fallback: the rank
    roundtrips its own ``(1, ...)`` row (updating its own error-feedback
    residual), then ONE broadcast from each of the K ranks gives it every
    roundtripped row ``rt_j``, and it accumulates ``W[k, j]·rt_j`` (with
    ``serverless``, its own term is ``W[k, k]`` times its exact value).
    O(K·model) traffic, as the reference's GSPMD gather. ``live`` is the
    whole row; only a live rank writes its row (and correction)."""
    engine_mod.check_one_row(stacked, pod, "dense mix", weights)
    k = pod.index
    W = weights.float()
    own = pod.local(live)
    xs = leaves(stacked)
    cs = leaves(corr) if corr is not None else [None] * len(xs)
    vals = [t.float() + c if c is not None else t.float()
            for t, c in zip(xs, cs)]
    sent = (stacked if corr is None else unflatten_like(
        stacked, [v.to(t.dtype) for v, t in zip(vals, xs)]))
    if codec.per_leaf:
        es = leaves(residual) if codec.stateful else [None] * len(xs)
        rts = []
        for i, t in enumerate(leaves(sent)):
            q, e_new = codec.leaf_roundtrip(t, es[i])
            if codec.stateful:
                engine_mod.commit(es[i], e_new, own)
            rts.append(q)
        new_res = residual
    elif codec.stateful:
        rt, new_res = codec.roundtrip_ef(sent, residual)
        rts = leaves(rt)
    else:
        rts, new_res = leaves(codec.roundtrip(sent)), None
    payload = [q.float() for q in rts]
    acc = [torch.mul(v, W[k, k]) if serverless else torch.zeros_like(v)
           for v in vals]
    for j in range(pod.size):
        buf = payload if j == k else [torch.empty_like(p) for p in payload]
        pod.broadcast_(buf, j, op="dense")
        if serverless and j == k:
            continue
        for a, b in zip(acc, buf):
            a.add_(torch.mul(b, W[k, j]))
    for t, c, a in zip(xs, cs, acc):
        if c is not None:
            engine_mod.commit(c, a - t.float(), own)
        engine_mod.commit(t, a.to(t.dtype), own)
    return stacked, new_res


def _make_weighted_psum_aggregate(aggregator, codec, mesh, param_specs,
                                  axis):
    """Pod-path broadcast-weighted mean, shared by the aggregators whose
    matrix has identical rows (weighted :class:`FullAverage`,
    :class:`PartialParticipation`, the uniform error-feedback mean): each
    rank scales its codec-roundtripped row by ``W[0, k]`` and ONE f32
    all-reduce of every leaf sums them, O(model) traffic. A stateful
    codec's roundtrip is the error-feedback one, and its residual stays on
    its rank: ``aggregate(stacked, weights, residual) -> (mixed,
    new_res)``."""
    pod = PodAxis(mesh, axis)
    stateful = getattr(codec, "stateful", False)

    @torch.no_grad()
    def mix(stacked, weights, residual, live):
        _check_one_row_per_pod(aggregator, stacked, pod, weights)
        if stateful:
            rt, new_res = codec.roundtrip_ef(stacked, residual)
        else:
            rt, new_res = codec.roundtrip(stacked), None
        w = weights[0][pod.index].float()
        parts = [torch.mul(t.float(), w) for t in leaves(rt)]
        del rt
        pod.all_reduce_(parts, op="psum")
        own = pod.local(live)
        for t, p in zip(leaves(stacked), parts):
            engine_mod.commit(t, p.to(t.dtype), own)
        return stacked, new_res

    if stateful:
        def aggregate_ef(stacked, weights, residual, live=None):
            return mix(stacked, weights, residual, live)
        return _on_pod(aggregate_ef, pod)

    def aggregate(stacked, weights, live=None):
        return mix(stacked, weights, None, live)[0]
    return _on_pod(aggregate, pod)


def _check_base(weights, K):
    base = (np.ones(K, np.float64) if weights is None
            else np.asarray(weights, np.float64))
    if base.shape != (K,):
        raise ValueError(f"weights must have length K={K}")
    if not np.isfinite(base).all() or (base < 0).any():
        raise ValueError(f"weights must be finite and >= 0; got {base}")
    return base


class Aggregator(abc.ABC):
    """Who aggregates what: a per-round mixing matrix + byte accounting.
    ``make_aggregate_fn(codec)`` returns ``aggregate(stacked, weights,
    live=None)`` (``aggregate(stacked, weights, state, live=None) ->
    (mixed, new_state)`` when the codec or the aggregator is stateful).
    The result may be ``stacked``'s own storage; with a liveness row it
    writes only the live rows."""

    name: str = "aggregator"
    uses_weights: bool = True
    #: True => ``comm_bytes`` does not depend on the round for fixed param
    #: shapes, so the learner prices it once instead of every round
    static_comm: bool = True

    @abc.abstractmethod
    def mixing_matrix(self, round_index: int, K: int,
                      live=None) -> np.ndarray:
        """Row-stochastic (K, K) f32 matrix for this round (host-side).
        ``live`` (elastic membership): a bool (K,) row; the matrix then
        mixes over live columns only (dead rows are restored by the
        engine)."""

    def make_aggregate_fn(self, codec: WireCodec, *, mesh=None,
                          param_specs=None, axis="pod", dynamic=False):
        """The round's aggregate function for ``codec``. ``dynamic=True``
        (elastic membership): the matrix changes per round, so the
        function honours ``weights`` on every call.

        ``mesh`` (a ``DeviceMesh`` with an ``axis`` dim): the pod path,
        the specialisation hook ``_make_mesh_aggregate_fn``, else the
        dense fallback (``_pod_mix_into``). A row may be laid out inside
        its pod (DTensor leaves, :func:`_intra_pod`). ``param_specs`` (the
        reference's) are accepted and not needed."""
        fn = self._build_aggregate_fn(codec, mesh, param_specs, axis,
                                      dynamic)
        return fn if mesh is None else _intra_pod(fn, codec)

    def _build_aggregate_fn(self, codec, mesh, param_specs, axis, dynamic):
        if mesh is not None:
            fn = self._make_mesh_aggregate_fn(codec, mesh, param_specs, axis,
                                              dynamic=dynamic)
            if fn is not None:
                return fn
            pod = PodAxis(mesh, axis)
            return _on_pod(self._make_host_aggregate_fn(
                codec, mix=functools.partial(_pod_mix_into, pod)), pod,
                dense=True)
        return self._make_host_aggregate_fn(codec)

    def _make_host_aggregate_fn(self, codec, mix=_mix_into):
        """The dense mix (``mix``: ``_mix_into``, or its pod form for the
        dense fallback)."""
        if getattr(codec, "stateful", False):
            def aggregate_ef(stacked, weights, residual, live=None):
                return mix(codec, stacked, weights, residual, live,
                           serverless=False)
            return aggregate_ef

        def aggregate(stacked, weights, live=None):
            return mix(codec, stacked, weights, None, live,
                       serverless=False)[0]
        return aggregate

    def _make_mesh_aggregate_fn(self, codec, mesh, param_specs, axis,
                                dynamic=False):
        """Pod-path specialisation hook: an aggregate whose only traffic
        is the aggregator's own wire pattern (a psum, a permute, ...).
        None falls back to the dense mix. ``dynamic=True``: the matrix
        varies per round; return None unless the specialisation honours
        ``weights``."""
        return None

    @abc.abstractmethod
    def comm_bytes(self, codec: WireCodec, stacked, round_index: int,
                   live=None) -> int:
        """Per-participant wire bytes for this round (upload + download);
        ``live``: a bool (K,) row, only live rows touch the wire."""

    @property
    def stateful(self) -> bool:
        """True when the AGGREGATOR carries per-participant round state
        (:class:`D2Gossip`'s correction); it rides the engines' one
        round-state slot with the codec's error-feedback memory."""
        return False

    def init_round_state(self, codec: WireCodec, stacked):
        if getattr(codec, "stateful", False):
            return codec.init_state(stacked)
        return None


@dataclasses.dataclass(frozen=True)
class FullAverage(Aggregator):
    """Paper Eq. 2: every participant uploads, the server averages, everyone
    downloads the shared model. ``weights=None`` is the uniform mean,
    routed through the codec's fused-mean kernel when it has one;
    ``weights=(n_1, ..., n_K)`` is FedAvg's example-count weighting.
    Under elastic membership the (weighted) row renormalises over the
    live participants and always takes the weighted route."""

    weights: tuple | None = None
    name = "full"

    @property
    def uses_weights(self):
        return self.weights is not None

    def mixing_matrix(self, round_index, K, live=None):
        if live is None:
            if self.weights is None:
                return np.full((K, K), 1.0 / K, np.float32)
            w = normalized_weights(self.weights, K)
            return np.broadcast_to(w, (K, K)).astype(np.float32)
        # a dead row's stale model must not drag the mean
        w = _check_base(self.weights, K) * np.asarray(live, bool)
        if not w.sum() > 0:
            raise ValueError(
                "no live participant carries averaging weight at round "
                f"{round_index} (live={np.asarray(live, bool)})")
        w /= w.sum()
        return np.broadcast_to(w, (K, K)).astype(np.float32)

    def _build_aggregate_fn(self, codec, mesh, param_specs, axis, dynamic):
        stateful = getattr(codec, "stateful", False)
        if self.weights is not None or dynamic:
            # a per-round weight row: always the weighted paths
            fused = codec.make_fused_mean(mesh=mesh, axis=axis,
                                          weighted=True, stateful=stateful)
            if fused is not None:
                if stateful:
                    return _carry(fused, lambda stacked, weights, residual,
                                  live=None: fused(stacked, weights[0],
                                                   residual, live=live))
                return _carry(fused, lambda stacked, weights, live=None:
                              fused(stacked, weights[0], live=live))
            if mesh is not None:
                return _make_weighted_psum_aggregate(self, codec, mesh,
                                                     param_specs, axis)
            return self._make_host_aggregate_fn(codec)
        fused = codec.make_fused_mean(mesh=mesh, axis=axis,
                                      stateful=stateful)
        if fused is not None:
            if stateful:
                return _carry(fused, lambda stacked, weights, residual,
                              live=None: fused(stacked, residual, live=live))
            return _carry(fused, lambda stacked, weights=None, live=None:
                          fused(stacked, live=live))
        if mesh is not None:
            if stateful:
                # the broadcast-weighted psum with a uniform row: each
                # rank's residual stays on it
                psum = _make_weighted_psum_aggregate(self, codec, mesh,
                                                     param_specs, axis)
                K = psum.pod.size
                dev = torch.device(mesh.device_type)
                uni = torch.full((K, K), 1.0 / K, dtype=torch.float32,
                                 device=dev)
                return _carry(psum, lambda stacked, weights, residual,
                              live=None: psum(stacked, uni, residual,
                                              live=live))
            sm = averaging.make_average_shard_map(mesh, param_specs, axis)
            return _carry(sm, lambda stacked, weights=None, live=None: sm(
                codec.roundtrip(stacked), live=live))
        if stateful:
            def aggregate_ef(stacked, weights, residual, live=None):
                rt, new_res = codec.roundtrip_ef(stacked, residual)
                return averaging.average_pjit(rt, live=live), new_res
            return aggregate_ef
        return lambda stacked, weights=None, live=None: \
            averaging.average_pjit(codec.roundtrip(stacked), live=live)

    def comm_bytes(self, codec, stacked, round_index, live=None):
        # the per-LIVE-participant bill is the same expression (the pod
        # path's all-reduce moves the dequantized f32 payload, as the
        # reference's psum does; this is the encoded size)
        return codec.wire_bytes(stacked) + participant_bytes(stacked)


@dataclasses.dataclass(frozen=True)
class PartialParticipation(Aggregator):
    """FedAvg-style partial participation (McMahan et al., 1602.05629):
    each round samples ``m <= K`` participants without replacement among
    those with positive weight, and the new shared model is their weighted
    average over the codec's wire, broadcast back to every participant
    (all K keep training; only the sampled uploads cross the WAN).

    ``weights``: optional length-K per-participant weights (the shard
    example counts for FedAvg's weighting); None is uniform over the
    sampled participants, and ``CoLearner(shard_sizes=...)`` wires the
    shard sizes in. The draw is a numpy ``default_rng(SeedSequence([seed,
    round]))``, so both engines (and the JAX package) see the same
    rounds; the matrix reaches the engines through
    ``CoLearner.round_weights``' static buffer. Under elastic membership
    only live participants are drawn, ``m_eff = min(m, n_live)``."""

    m: int = 2
    weights: tuple | None = None
    seed: int = 0
    name = "partial"

    def mixing_matrix(self, round_index, K, live=None):
        if not 1 <= self.m <= K:
            raise ValueError(f"need 1 <= m <= K, got m={self.m} K={K}")
        base = _check_base(self.weights, K)
        if live is not None:
            base = base * np.asarray(live, bool)
            if not (base > 0).any():
                raise ValueError(
                    "partial participation has zero live participants "
                    f"with positive weight at round {round_index} "
                    f"(live={np.asarray(live, bool)})")
        # only participants with weight can be sampled: a sample of
        # zero-weight ones would normalise 0/0 into a NaN matrix
        eligible = np.nonzero(base > 0)[0]
        m_eff = min(self.m, len(eligible)) if live is not None else self.m
        if len(eligible) < m_eff:
            raise ValueError(
                f"need m={m_eff} participants with positive weight; "
                f"only {len(eligible)} of K={K} have one")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, round_index]))
        sel = rng.choice(eligible, size=m_eff, replace=False)
        w = np.zeros(K, np.float64)
        w[sel] = base[sel]
        w /= w.sum()
        # every row identical: all K download the same new shared model
        return np.broadcast_to(w, (K, K)).astype(np.float32)

    def _make_mesh_aggregate_fn(self, codec, mesh, param_specs, axis,
                                dynamic=False):
        # identical rows (everyone downloads the same weighted mean): the
        # weighted psum, which honours the row every call (live sets too)
        return _make_weighted_psum_aggregate(self, codec, mesh, param_specs,
                                             axis)

    def comm_bytes(self, codec, stacked, round_index, live=None):
        K = leaves(stacked)[0].shape[0]
        up = codec.wire_bytes(stacked)          # only m of K pay the upload
        if live is not None:
            n_live = max(int(np.asarray(live, bool).sum()), 1)
            # the sampled uploads amortise over the n_live rows; every
            # live row pays the download
            return (math.ceil(min(self.m, n_live) * up / n_live)
                    + participant_bytes(stacked))
        return math.ceil(self.m * up / K) + participant_bytes(stacked)


@dataclasses.dataclass(frozen=True)
class GraphGossip(Aggregator):
    """One gossip exchange per round over a sparse topology (consensus
    SGD, Jiang et al., 1706.07880): no server — participant k mixes its
    model with its graph neighbours' through the topology's
    row-stochastic (all-live: doubly stochastic) mixing matrix.

    ``topology`` is a ``core/topology.py`` instance or registry name; None
    is the ring. A time-varying graph's per-round matrix reaches the fused
    engine through ``CoLearner.round_weights``' static buffer, so a graph
    change never captures again. Disconnected topologies are rejected at
    learner construction (``validate``). Liveness renormalises over the
    live subgraph. Matrices are memoised per (round-key, K, live-set), at
    most 512 of them. Serverless: a row's own model never crosses the
    wire, so only the received (off-diagonal) leg goes through the
    codec."""

    topology: Any = None

    def __post_init__(self):
        object.__setattr__(self, "topology",
                           topo_mod.get_topology(self.topology))
        object.__setattr__(self, "_mix_cache", {})

    @property
    def name(self):
        return f"graph[{self.topology.name}]"

    @property
    def static_comm(self):
        # a time-varying graph's edge count (and so its bill) can change
        # per round even with every participant up
        return not self.topology.time_varying

    def validate(self, K: int) -> "GraphGossip":
        """Connectivity guard (``CoLearner`` calls it at construction)."""
        self.topology.validate(K)
        return self

    def _round_key(self, round_index, K):
        topo = self.topology
        return (round_index % topo.period(K)) if topo.time_varying else 0

    def mixing_matrix(self, round_index, K, live=None):
        lkey = (None if live is None
                else tuple(bool(x) for x in np.asarray(live, bool)))
        key = (self._round_key(round_index, K), K, lkey)
        W = self._mix_cache.get(key)
        if W is None:
            W = self.topology.mixing_matrix(round_index, K, live=live)
            W.flags.writeable = False           # cached: nobody may edit
            if len(self._mix_cache) >= 512:     # random churn could grow
                self._mix_cache.clear()         # the live-key space: bound
            self._mix_cache[key] = W
        return W

    def _make_host_aggregate_fn(self, codec, mix=_mix_into):
        if getattr(codec, "stateful", False):
            def aggregate_ef(stacked, weights, residual, live=None):
                return mix(codec, stacked, weights, residual, live,
                           serverless=True)
            return aggregate_ef

        def aggregate(stacked, weights, live=None):
            return mix(codec, stacked, weights, None, live,
                       serverless=True)[0]
        return aggregate

    def _mesh_perm_setup(self, mesh, axis, dynamic):
        """The sparse pod wire pattern: the graph's edge permutations and,
        per permutation, the ``(K,)`` "k receives from src[k]" map that
        picks each leg's weight ``W[k, src[k]]`` out of the matrix. None —
        the dense fallback — when the graph is irregular (no permutation
        decomposition), time-varying (a wire pattern per round), or
        elastic membership may route edges outside the pattern."""
        topo = self.topology
        if dynamic or topo.time_varying:
            return None
        K = axis_sizes(mesh)[axis]
        perms = topo.edge_perms(0, K)
        if not perms:
            return None
        srcs = []
        for perm in perms:
            if len(perm) != K or len({d for _, d in perm}) != K:
                return None         # partial permute: some pod gets zeros
            src = [0] * K
            for s_, d in perm:
                src[d] = s_
            srcs.append(tuple(src))
        return tuple(tuple(p) for p in perms), tuple(srcs)

    def _make_mesh_aggregate_fn(self, codec, mesh, param_specs, axis,
                                dynamic=False):
        if getattr(codec, "stateful", False):
            return None     # no residual plumbing here: the dense fallback
        setup = self._mesh_perm_setup(mesh, axis, dynamic)
        if setup is None:
            return None
        perms, srcs = setup
        pod = PodAxis(mesh, axis)

        # one point-to-point exchange per permutation: each rank
        # roundtrips its own row (its send leg) and receives exactly degree
        # rows, O(degree) traffic; its own half stays exact
        @torch.no_grad()
        def aggregate(stacked, weights, live=None):
            _check_one_row_per_pod(self, stacked, pod, weights)
            k = pod.index
            W = weights.float()
            qs = [q.float() for q in leaves(codec.roundtrip(stacked))]
            acc = [torch.mul(t.float(), W[k, k]) for t in leaves(stacked)]
            for perm, src in zip(perms, srcs):
                recv = pod.permute(qs, perm, op="gossip")
                for a, r in zip(acc, recv):
                    a.add_(r.mul_(W[k, src[k]]))
            own = pod.local(live)
            for t, a in zip(leaves(stacked), acc):
                engine_mod.commit(t, a.to(t.dtype), own)
            return stacked
        return _on_pod(aggregate, pod)

    def comm_bytes(self, codec, stacked, round_index, live=None):
        # every directed live edge moves one encoded model, and each
        # participant pays its send AND receive legs: 2·edges/n_live
        # encoded models per live participant, O(degree), never O(K)
        K = leaves(stacked)[0].shape[0]
        n = K
        if live is not None:
            n = int(np.asarray(live, bool).sum())
            if n <= 1:
                return 0             # a sole survivor has nobody to gossip
        W = self.mixing_matrix(round_index, K, live=live)
        n_edges = (int(np.count_nonzero(W))
                   - int(np.count_nonzero(np.diagonal(W))))
        if n_edges == 0:
            return 0
        return math.ceil(2 * n_edges * codec.wire_bytes(stacked) / n)


@dataclasses.dataclass(frozen=True)
class RingGossip(GraphGossip):
    """One neighbour exchange over a fixed ring: participant k averages its
    model with its ring predecessor's, ``w_k' = (w_k + w_{(k-1) mod K}) /
    2``. It IS ``GraphGossip(RingTopology())``, kept for the ``"ring"``
    registry name and its bill, ``2 · wire_bytes``."""

    name = "ring"

    def __post_init__(self):
        super().__post_init__()
        if not isinstance(self.topology, topo_mod.RingTopology):
            raise ValueError(
                "RingGossip is fixed to the ring topology; use "
                f"GraphGossip(topology={self.topology.name!r}) instead")

    def _make_mesh_aggregate_fn(self, codec, mesh, param_specs, axis,
                                dynamic=False):
        # the static permute bakes the all-live ring and has no residual
        # plumbing: a stateful codec or a per-round (live) matrix takes the
        # dense fallback
        if getattr(codec, "stateful", False) or dynamic:
            return None
        pod = PodAxis(mesh, axis)
        K = pod.size
        perm = tuple((j, (j + 1) % K) for j in range(K))

        # one exchange: each rank roundtrips its own row (the send leg) and
        # receives its predecessor's; its own half stays exact
        @torch.no_grad()
        def aggregate(stacked, weights=None, live=None):
            del weights                         # the ring matrix is static
            _check_one_row_per_pod(self, stacked, pod)
            qs = [q.float() for q in leaves(codec.roundtrip(stacked))]
            recv = pod.permute(qs, perm, op="ring")
            own = pod.local(live)
            for t, r in zip(leaves(stacked), recv):
                engine_mod.commit(t, (0.5 * t.float() + 0.5 * r).to(t.dtype),
                                  own)
            return stacked
        return _on_pod(aggregate, pod)

    def comm_bytes(self, codec, stacked, round_index, live=None):
        # one encoded model sent, one received (the general per-live-edge
        # bill reduces to this for every ring live set)
        if live is not None and int(np.asarray(live, bool).sum()) <= 1:
            return 0                 # a sole survivor has nobody to gossip
        return 2 * codec.wire_bytes(stacked)


@dataclasses.dataclass(frozen=True)
class D2Gossip(GraphGossip):
    """:class:`GraphGossip` plus the D² variance-reduction correction
    (Tang et al., 1803.07068) in round form, with one extra model-shaped
    f32 memory per participant and zero extra wire traffic::

        v_k   = y_k + c_k        post-training model + correction
        x_k'  = Σ_j W[k,j] v_j   the usual gossip mix (v on the wire)
        c_k'  = x_k' - y_k       next round's correction

    On identical shards the correction stays exactly zero and D² is plain
    gossip. The correction is aggregator round state in the engines' one
    round-state slot (``stateful`` / ``init_round_state``): persisted by
    ``checkpoint/io.py``, carried unchanged through quiet
    ``DivergenceTrigger`` rounds, frozen for dead slots and zeroed per row
    on ``restart_participant``. With an error-feedback codec both
    memories ride together as ``{"corr": ..., "res": ...}``. The mix runs
    leaf by leaf in place, the correction updated with it."""

    @property
    def name(self):
        return f"d2[{self.topology.name}]"

    @property
    def stateful(self):
        return True

    def init_round_state(self, codec, stacked):
        corr = tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                              device=t.device), stacked)
        if getattr(codec, "stateful", False):
            return {"corr": corr, "res": codec.init_state(stacked)}
        return corr

    def _make_host_aggregate_fn(self, codec, mix=_mix_into):
        codec_ef = getattr(codec, "stateful", False)

        def aggregate(stacked, weights, state, live=None):
            corr = state["corr"] if codec_ef else state
            res = state["res"] if codec_ef else None
            _, new_res = mix(codec, stacked, weights, res, live,
                             serverless=True, corr=corr)
            return stacked, ({"corr": corr, "res": new_res} if codec_ef
                             else corr)
        return aggregate

    def _make_mesh_aggregate_fn(self, codec, mesh, param_specs, axis,
                                dynamic=False):
        if getattr(codec, "stateful", False):
            # the correction with an error-feedback residual takes the
            # dense fallback, as in the reference
            return None
        setup = self._mesh_perm_setup(mesh, axis, dynamic)
        if setup is None:
            return None
        perms, srcs = setup
        pod = PodAxis(mesh, axis)

        # the permutes of GraphGossip over v = y + c; the correction stays
        # on its rank
        @torch.no_grad()
        def aggregate(stacked, weights, corr, live=None):
            _check_one_row_per_pod(self, stacked, pod, weights)
            k = pod.index
            W = weights.float()
            xs, cs = leaves(stacked), leaves(corr)
            vf = [t.float() + c for t, c in zip(xs, cs)]
            vw = unflatten_like(stacked, [v.to(t.dtype)
                                          for v, t in zip(vf, xs)])
            qs = [q.float() for q in leaves(codec.roundtrip(vw))]
            del vw
            acc = [torch.mul(v, W[k, k]) for v in vf]
            for perm, src in zip(perms, srcs):
                recv = pod.permute(qs, perm, op="gossip")
                for a, r in zip(acc, recv):
                    a.add_(r.mul_(W[k, src[k]]))
            own = pod.local(live)
            for t, c, a in zip(xs, cs, acc):
                engine_mod.commit(c, a - t.float(), own)
                engine_mod.commit(t, a.to(t.dtype), own)
            return stacked, corr
        return _on_pod(aggregate, pod)


# ---------------------------------------------------------------------------
# LRSchedule (Eq. 3 family)
# ---------------------------------------------------------------------------
class LRSchedule(abc.ABC):
    """The per-epoch learning rate policy (the Eq. 3 axis).

    Two surfaces, one semantics:

    * ``lr(round_i, epoch_j, T_i, global_epoch, total_budget)`` — the
      host rate the python engine evaluates once per epoch.
    * ``round_params(round_i)`` — the per-round host hook: ``(kind, p)``,
      the branch index and scalar pack that ``schedule.switch_lr`` (the
      shared device body, :attr:`traced_lr`) consumes as device tensors
      inside the fused engine's captured graphs. A schedule whose
      parameters move per round (a warmup ramping η^i) therefore never
      captures again, and swapping between built-ins reuses the graphs.

    A subclass may override :attr:`traced_lr` with its own device
    function; swapping to or from it rebinds the fused engine
    (``CoLearner.set_schedule``), whose graphs are then captured anew.
    """

    name: str = "schedule"
    #: the device body the fused engine embeds; shared by every built-in
    traced_lr = staticmethod(switch_lr)

    @abc.abstractmethod
    def lr(self, round_i, epoch_j, T_i, global_epoch, total_budget):
        """The epoch's learning rate (host form)."""

    @abc.abstractmethod
    def round_params(self, round_i):
        """Host hook: ``(kind, (p0, p1, p2, p3))`` for ``switch_lr``."""

    def device_round_params(self, round_i, device=None):
        """``round_params`` as the device pack the fused engine takes,
        staged explicitly (``engine.stage``) onto ``device`` (the card
        unless the caller passes ``"cpu"``)."""
        kind, p = self.round_params(round_i)
        p = tuple(p) + (0.0,) * (N_SCHED_PARAMS - len(p))
        dev = resolve_device(device)
        return {"kind": engine_mod.stage(kind, np.int32, dev),
                "p": engine_mod.stage(p, np.float32, dev)}


def traced_body(schedule: LRSchedule):
    """The schedule's device lr function as a plain callable: unwraps the
    bound method a subclass gets when it overrides ``traced_lr`` with a
    plain function, so identity comparison (the hot-swap check) works and
    the engine calls it as ``lr_fn(sched, j, T_i, ge, total)``."""
    fn = schedule.traced_lr
    return getattr(fn, "__func__", fn)


@dataclasses.dataclass(frozen=True)
class CLR(LRSchedule):
    """Paper Eq. 3: η_j^i = η^i · r^(j/T_i), restarting at η^i every round."""

    eta0: float = 0.01
    decay_rate: float = 0.25
    name = "clr"

    def round_eta(self, round_i) -> float:
        """The round's shared base rate η^i (constant for plain CLR)."""
        return self.eta0

    def lr(self, round_i, epoch_j, T_i, global_epoch, total_budget):
        return clr_lr(self.round_eta(round_i), self.decay_rate, epoch_j, T_i)

    def round_params(self, round_i):
        return LR_EXP_ROUND, (self.round_eta(round_i), self.decay_rate)


@dataclasses.dataclass(frozen=True)
class ELR(LRSchedule):
    """The non-cyclical baseline: one exponential anneal over the run's
    whole epoch budget, never restarting. The budget arrives as a device
    tensor each round (``SyncPolicy.epochs_budget``)."""

    eta0: float = 0.01
    decay_rate: float = 0.25
    name = "elr"

    def lr(self, round_i, epoch_j, T_i, global_epoch, total_budget):
        return elr_lr(self.eta0, self.decay_rate, global_epoch,
                      max(total_budget, 1))

    def round_params(self, round_i):
        return LR_EXP_GLOBAL, (self.eta0, self.decay_rate)


@dataclasses.dataclass(frozen=True)
class WarmupCLR(CLR):
    """CLR with η^i ramped linearly over the first ``warmup_rounds``
    rounds: η^i = η0 · min(1, (i+1)/warmup_rounds). The ramp lives in the
    per-round host hook, so the fused engine sees only another η^i in its
    parameter pack."""

    warmup_rounds: int = 3
    name = "warmup_clr"

    def round_eta(self, round_i) -> float:
        ramp = min(1.0, (round_i + 1) / max(self.warmup_rounds, 1))
        return self.eta0 * ramp


@dataclasses.dataclass(frozen=True)
class CosineCyclical(LRSchedule):
    """SGDR-style cyclical cosine: within round i the rate anneals from
    η^i to ``eta_min`` on a half-cosine over the round's T_i epochs and
    restarts at η^i at the next round."""

    eta0: float = 0.01
    eta_min: float = 0.0
    name = "cosine"

    def lr(self, round_i, epoch_j, T_i, global_epoch, total_budget):
        return cosine_lr(self.eta0, self.eta_min, epoch_j, T_i)

    def round_params(self, round_i):
        return LR_COS_ROUND, (self.eta0, 0.0, self.eta_min)


# ---------------------------------------------------------------------------
# SyncPolicy (Eq. 4 generalized)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SyncState:
    """Host-side per-run state owned by a :class:`SyncPolicy`: ``history``
    logs one ``(round, rel_change, next_T)`` triple per round, ``skipped``
    the rounds a divergence-gated policy decided not to communicate."""

    T: int
    history: tuple = ()
    skipped: tuple = ()


class SyncPolicy(abc.ABC):
    """Who syncs when: next round's T_i and, for a divergence-gated
    policy, the communicate-at-all decision.

    The gate has two forms that must agree: ``should_sync`` on the host
    (the python engine) and ``traced_should_sync`` on device tensors (the
    fused engine's gate graph). ``round_delta`` is the round's threshold
    as both engines consume it (the fused engine copies it into a static
    0-d buffer, so a new δ never captures again)."""

    name: str = "sync"
    #: True => quiet rounds (the gate says no) skip the aggregation and
    #: the wire (Kamp et al.)
    divergence_gated: bool = False
    #: the divergence threshold (gated policies only)
    delta: float = float("inf")

    def init_state(self, T0: int) -> SyncState:
        return SyncState(T=int(T0))

    @abc.abstractmethod
    def update(self, state: SyncState, round_i: int, rel_change: float,
               synced: bool = True, events: tuple = ()) -> SyncState:
        """Fold the round's Eq. 4 metric (on a quiet round the divergence)
        into the state; returns the state whose ``T`` drives round
        ``round_i + 1``. ``events``: the round's membership events (a
        policy reading ``rel_change`` as a convergence signal holds its
        decision on such rounds)."""

    def should_sync(self, div: float, round_i: int, delta=None) -> bool:
        """Host gate (python engine); ``delta`` overrides the static
        threshold when :meth:`round_delta` moved it for this round."""
        return True

    def round_delta(self, events: tuple = ()):
        """The round's divergence threshold (host hook)."""
        return self.delta

    def traced_should_sync(self, div, delta):
        """The gate on device tensors (0-d ``div`` and ``delta``) -> 0-d
        bool tensor. Override together with :meth:`should_sync`; a swap to
        a policy with another traced gate goes through
        ``CoLearner.set_sync_policy`` so the fused engine rebinds."""
        return div > delta

    def epochs_budget(self, T: int, round_i: int, global_epoch: int,
                      max_rounds: int) -> int:
        """Epochs already run plus the current T_i over the remaining
        rounds (the ELR anneal's denominator)."""
        return max(global_epoch + T * max(max_rounds - round_i, 1), 1)


@dataclasses.dataclass(frozen=True)
class ILE(SyncPolicy):
    """Paper Eq. 4: double T_i when the relative change of the averaged
    model falls to <= ε; always communicates."""

    epsilon: float = 0.01
    name = "ile"

    def update(self, state, round_i, rel_change, synced=True, events=()):
        # hold the doubling on membership-change rounds: the metric moved
        # because the live set did, not because training settled
        T = (2 * state.T if rel_change <= self.epsilon and not events
             else state.T)
        return dataclasses.replace(
            state, T=T, history=state.history + ((round_i, rel_change, T),))


@dataclasses.dataclass(frozen=True)
class FLE(SyncPolicy):
    """Fixed local epochs: T_i = T0 forever; always communicates."""

    name = "fle"

    def update(self, state, round_i, rel_change, synced=True, events=()):
        return dataclasses.replace(
            state,
            history=state.history + ((round_i, rel_change, state.T),))


@dataclasses.dataclass(frozen=True)
class DivergenceTrigger(SyncPolicy):
    """Dynamic model averaging (Kamp et al., 1807.03210): communicate only
    while the local models diverge.

    After the round's local epochs the engines compute the participants'
    RMS relative drift from the last synced shared model
    (``schedule.divergence_tensor``). While it stays <= δ the round is
    quiet: no aggregation and no wire, the participants keep their local
    params and optimizer state, and the round bills zero bytes.
    ``epsilon`` optionally adds the Eq. 4 doubling on synced rounds (None
    keeps T fixed)."""

    delta: float = 0.05
    epsilon: float | None = None
    name = "divtrigger"
    divergence_gated = True

    def should_sync(self, div, round_i, delta=None):
        return div > (self.delta if delta is None else delta)

    def round_delta(self, events=()):
        # a membership change forces the sync (the divergence, >= 0,
        # always exceeds -1)
        if events:
            return -1.0
        return self.delta

    def update(self, state, round_i, rel_change, synced=True, events=()):
        T = state.T
        if (synced and not events and self.epsilon is not None
                and rel_change <= self.epsilon):
            T = 2 * state.T
        skipped = state.skipped if synced else state.skipped + (round_i,)
        return dataclasses.replace(
            state, T=T, skipped=skipped,
            history=state.history + ((round_i, rel_change, T),))


# ---------------------------------------------------------------------------
# RoundEngine
# ---------------------------------------------------------------------------
class RoundEngine(abc.ABC):
    """How a round executes: ``bind(learner)`` returns a runner with
    ``run_round(state, epoch_batches_fn) -> state``."""

    name: str = "engine"

    @abc.abstractmethod
    def bind(self, learner):
        """Return a runner object for this learner."""


@dataclasses.dataclass(frozen=True)
class PythonEngine(RoundEngine):
    """Reference path: a host loop running one local epoch at a time,
    host-side Eq. 3 learning rates and Eq. 4 metric."""

    name = "python"

    def bind(self, learner):
        return _PythonRunner(learner)


def _gate_accepts_delta(policy) -> bool:
    """Whether the policy's host gate takes the per-round ``delta``
    override. A subclass that overrides ``should_sync(self, div,
    round_i)`` without it still gates on its static threshold, so it is
    called with that signature."""
    try:
        params = inspect.signature(type(policy).should_sync).parameters
    except (TypeError, ValueError):
        return True
    return "delta" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


class _PythonRunner:
    def __init__(self, learner):
        self.learner = learner
        self._stateful = learner._round_stateful

    def run_round(self, state, epoch_batches_fn):
        learner = self.learner
        policy = learner.sync_policy
        i = state["round"]
        T_i = state["ctrl"].T
        ge0 = state["global_epoch"]
        total = learner.epochs_budget(state)
        # the gate's reference, taken before the epochs move the params in
        # place (a copy of the first live slot before the first sync)
        sync_ref = (learner._sync_ref(state) if policy.divergence_gated
                    else None)
        # elastic membership: the liveness row rides into the epochs and
        # the aggregate as a device tensor (None on the static path)
        live_np = learner._live_np(state)
        live_row = (None if live_np is None else engine_mod.stage(
            live_np, np.float32, learner.device))
        lrs, losses = [], []
        for j in range(T_i):
            lr = float(learner.schedule.lr(i, j, T_i, ge0 + j, total))
            lrs.append(lr)
            batches = epoch_batches_fn(i, j)
            _, _, l = learner._epoch(state["params"], state["opt"],
                                     batches, lr, learner.batch_mask,
                                     live_row)
            losses.append(l)                  # (K,) stays on the device
        if policy.divergence_gated:
            div = divergence(state["params"], sync_ref, live_row)
            if _gate_accepts_delta(policy):
                synced = bool(policy.should_sync(
                    div, i, delta=learner._round_delta(state)))
            else:
                synced = bool(policy.should_sync(div, i))
        else:
            synced = True
        if synced:
            weights = learner.round_weights(i, state)
            kw = {} if live_row is None else {"live": live_row}
            if self._stateful:
                averaged, new_res = learner._aggregate_fn(
                    state["params"], weights, state["residual"], **kw)
            else:
                averaged = learner._aggregate_fn(state["params"], weights,
                                                 **kw)
                new_res = None
            k0 = 0
            fresh_opt = engine_mod.init_stacked_opt(learner.opt, averaged)
            if live_row is not None:
                # dead rows: identity carry (no download, own optimizer
                # state and round state kept), written into the state
                k0 = int(np.argmax(live_np))
                averaged = engine_mod.select_live(live_row, averaged,
                                                  state["params"])
                fresh_opt = engine_mod.select_live(live_row, fresh_opt,
                                                   state["opt"])
                if self._stateful:
                    new_res = engine_mod.select_live(live_row, new_res,
                                                     state["residual"])
            new_avg = averaging.unstack_participant(averaged, k0)
            rel = (float("inf") if state["prev_avg"] is None
                   else relative_change(new_avg, state["prev_avg"]))
        else:
            # quiet round (Kamp): local params AND optimizer state kept,
            # the reference unchanged, nothing on the wire (the residual
            # is untouched: nothing was quantized)
            averaged, fresh_opt = state["params"], state["opt"]
            new_avg, rel, new_res = sync_ref, div, None
        per_epoch = torch.stack(losses).cpu().numpy()     # one transfer
        return learner._finish_round(state, i, T_i, rel,
                                     _live_loss_means(per_epoch, live_np),
                                     lrs[0], lrs[-1], averaged, fresh_opt,
                                     new_avg, synced=synced,
                                     residual=new_res)


@dataclasses.dataclass(frozen=True)
class FusedEngine(RoundEngine):
    """Every round as the fused functions of ``core/engine.py``: T_i
    epochs with the Eq. 3 rate computed on the device, the aggregation and
    the Eq. 4 metric, and one host sync to fetch the losses, rates and
    ``rel``. On the card each is a CUDA graph captured once per layout
    (``core/graphs.py``) and replayed: rounds of up to ``chunk`` epochs
    replay one round graph, longer ones a chunk graph per ``chunk``
    epochs and then a finalize graph (staged-batch memory stays bounded).
    A divergence-gated round replays the chunk graphs and a gate graph,
    and the finalize graph only when the gate says sync (a second fetch).
    On the CPU the same functions run uncaptured."""

    chunk: int = 32
    name = "fused"

    def bind(self, learner):
        return _FusedRunner(learner, self.chunk)


def _live_loss_means(losses, live_np=None):
    """Per-epoch mean loss over the LIVE participants (all K when
    ``live_np`` is None: the static path)."""
    if live_np is None:
        return [float(np.asarray(x).mean()) for x in losses]
    w = np.asarray(live_np, np.float32)
    n_live = max(float(w.sum()), 1.0)
    return [float((np.asarray(x) * w).sum() / n_live) for x in losses]


class _FusedRunner:
    """Drives one learner's rounds through its graphs.

    Every result that outlives a replay lives in storage allocated outside
    capture: the state's params, optimizer state and residual (updated in
    place), the last shared model ``state["prev_avg"]`` (Eq. 4 and the
    divergence gate read it, then a synced round's finalize overwrites it
    with the new one), the learner's batch mask, and the static per-round
    buffers below, which the round writes with ``copy_`` before it
    replays. Only temporaries live in the graph pool.

    A divergence-gated round is split at the gate, since a captured graph
    cannot branch on device data: the epochs (the chunk graphs, for every
    gated round), then the gate graph (the divergence and the policy's
    traced decision), the round's first fetch, and only on a synced round
    the finalize graph and a second fetch of ``rel``. The host reads the
    device's decision; it never decides again.

    Under active churn (and only then) the graphs are the live variants:
    the liveness row is one ``(K,)`` f32 static buffer written with
    ``copy_`` inside the round's window, like the schedule's scalars, and
    the mixing matrix (renormalised over the live set, or a time-varying
    graph's) rides ``CoLearner.round_weights``' static buffer, so a leave,
    a rejoin or a new matrix never captures again. A static schedule
    keeps the static graphs."""

    def __init__(self, learner, chunk):
        # a weak reference: no cycle keeps a dead learner's graphs and their
        # pool alive until the collector runs
        self.learner = weakref.proxy(learner)
        self.chunk = chunk
        self._traced_lr = traced_body(learner.schedule)
        policy = learner.sync_policy
        self._gated = policy.divergence_gated
        self._traced_gate = type(policy).traced_should_sync
        self._masked = learner.batch_mask is not None
        self._live = learner._churn_active
        self._stateful = learner._round_stateful
        dev = learner.device
        if dev.type == "cuda" and isinstance(learner.codec,
                                             (LeafwiseIntN, FlatFusedIntN)):
            # the wire kernels are built and loaded before any capture
            from repro_torch.kernels._build import load
            load("wire")
        self.graphs = GraphSet(dev)
        lead = 3 if self._stateful else 2
        # the round graph's epochs / finalize split (read while tracing)
        self._marks = spans.marks(dev)
        rnd = engine_mod.make_fused_round(
            learner.loss_fn, learner.opt, lr_fn=self._traced_lr,
            aggregate_fn=learner._aggregate_fn, masked=self._masked,
            live=self._live, stateful=self._stateful, marks=self._marks)
        epochs = engine_mod.make_fused_epochs(
            learner.loss_fn, learner.opt, lr_fn=self._traced_lr,
            masked=self._masked, live=self._live)
        fin = engine_mod.make_fused_finalize(
            learner.opt, aggregate_fn=learner._aggregate_fn,
            live=self._live, stateful=self._stateful)
        gate = engine_mod.make_fused_gate(policy.traced_should_sync,
                                          live=self._live)

        # a graph's outputs are only its temporaries: the state it writes
        # is reached through the arguments
        def round_graph(*args):
            aux = rnd(*args)[2]
            return aux["losses"], aux["lrs"], aux["rel"]
        self._round = self.graphs.capture(round_graph, "round",
                                          inputs=(lead,))
        self._epochs = self.graphs.capture(lambda *a: epochs(*a)[2:],
                                           "epochs", inputs=(2,))
        self._finalize = self.graphs.capture(lambda *a: fin(*a)[2],
                                             "finalize")
        self._gate = self.graphs.capture(gate, "gate")

        def scalar(dtype, shape=()):
            return torch.zeros(shape, dtype=dtype, device=dev)
        self._j0, self._T, self._ge0, self._total = (
            scalar(torch.int32) for _ in range(4))
        self._delta = scalar(torch.float32)
        self._sched = {"kind": scalar(torch.int32),
                       "p": scalar(torch.float32, (N_SCHED_PARAMS,))}
        self._live_row = (scalar(torch.float32, (learner.cfg.n_participants,))
                          if self._live else None)

    def run_round(self, state, epoch_batches_fn):
        """One round: the staging, then a window free of host syncs (the
        scalar copies and the replays), then one fetch of the losses, the
        rates and ``rel`` (gated: ``div`` and the decision, then ``rel``
        in a second fetch on a synced round)."""
        learner = self.learner
        if traced_body(learner.schedule) is not self._traced_lr:
            raise RuntimeError(
                "the learner's schedule carries a different traced_lr than "
                "the captured round graphs; swap schedules with "
                "CoLearner.set_schedule(...) so the engine can rebind")
        policy = learner.sync_policy
        if (policy.divergence_gated != self._gated
                or type(policy).traced_should_sync is not self._traced_gate):
            raise RuntimeError(
                "the learner's sync policy gating does not match the "
                "captured round graphs; swap policies with "
                "CoLearner.set_sync_policy(...) so the engine can rebind")
        gated = self._gated
        dev = learner.device
        i = state["round"]
        T_i = state["ctrl"].T
        K = learner.cfg.n_participants
        live_np = learner._live_np(state)
        # the last shared model: read by Eq. 4 and the gate, then
        # overwritten in place by the new one on a synced round (before the
        # first round a copy of the first live slot: an ungated round
        # reports rel inf, a quiet one keeps the copy as the reference)
        first = state["prev_avg"] is None
        k0 = 0 if live_np is None else int(np.argmax(live_np))
        prev_avg = (averaging.unstack_participant(state["params"], k0)
                    if first else state["prev_avg"])
        single = T_i <= self.chunk and not gated
        chunks = ([(0, T_i)] if single else
                  [(j0, min(self.chunk, T_i - j0))
                   for j0 in range(0, T_i, self.chunk)])

        def staged(j0, C):
            return engine_mod.stack_epoch_batches(
                [epoch_batches_fn(i, j) for j in range(j0, j0 + C)], dev)

        # the staging: every host-to-device transfer of the round
        with spans.span("rt.round.stage"):
            sched = learner.schedule.device_round_params(i, dev)
            ints = engine_mod.stage(
                [state["global_epoch"], learner.epochs_budget(state), T_i]
                + [j0 for j0, _ in chunks], np.int32, dev)
            delta = (engine_mod.stage(learner._round_delta(state),
                                      np.float32, dev) if gated else None)
            live_h = (engine_mod.stage(live_np, np.float32, dev)
                      if self._live else None)
            agg_w = learner.round_weights(i, state)
            batches = staged(*chunks[0])
        # the batch mask and the liveness row follow the batches
        mask = (() if not self._masked else (learner.batch_mask,)) + (
            (self._live_row,) if self._live else ())
        live = (self._live_row,) if self._live else ()
        lead = ((state["params"], state["opt"], state["residual"])
                if self._stateful else (state["params"], state["opt"]))
        with spans.span("rt.round.replay"), self.graphs.no_sync():
            self._sched["kind"].copy_(sched["kind"])
            self._sched["p"].copy_(sched["p"])
            for buf, k in ((self._ge0, 0), (self._total, 1), (self._T, 2)):
                buf.copy_(ints[k])
            if self._live:
                self._live_row.copy_(live_h)
            if single:
                losses, lrs, last = self._round(
                    *lead, batches, *mask, prev_avg, self._ge0, self._sched,
                    self._total, agg_w)
            else:
                lparts, rparts = [], []
                for c, (j0, C) in enumerate(chunks):
                    if c:
                        with allow_sync():
                            batches = staged(j0, C)
                    self._j0.copy_(ints[3 + c])
                    l, r = self._epochs(
                        state["params"], state["opt"], batches, *mask,
                        self._j0, self._T, self._ge0, self._sched,
                        self._total)
                    lparts.append(l.clone())
                    rparts.append(r.clone())
                losses, lrs = torch.cat(lparts), torch.cat(rparts)
                if gated:
                    self._delta.copy_(delta)
                    div, do_sync = self._gate(state["params"], prev_avg,
                                              self._delta, *live)
                    last = torch.stack([div.float(), do_sync.float()])
                else:
                    last = self._finalize(*lead, prev_avg, *live, agg_w)
            fetch = torch.cat([losses.reshape(-1), lrs, last.reshape(-1)])
        with spans.span("rt.round.fetch"):
            host = fetch.cpu().numpy()        # the round's (first) host sync
        # the graph's marks are done with the fetch: no sync of their own
        split = spans.between(self._marks) if single else None
        losses = host[:T_i * K].reshape(T_i, K)
        lrs = host[T_i * K:T_i * K + T_i]
        synced = not gated or bool(host[-1])
        if not synced:
            rel = float(host[-2])             # a quiet round reports div
        elif gated:
            with self.graphs.no_sync():
                rel_t = self._finalize(*lead, prev_avg, *live,
                                       agg_w).reshape(1)
            rel_h = float(rel_t.cpu()[0])     # the synced round's second
            rel = float("inf") if first else rel_h
        else:
            rel = float("inf") if first else float(host[-1])
        with spans.span("rt.round.finish"):
            return learner._finish_round(
                state, i, T_i, rel, _live_loss_means(losses, live_np),
                float(lrs[0]),
                float(lrs[-1]), state["params"], state["opt"], prev_avg,
                synced=synced,
                residual=state["residual"] if self._stateful else None,
                device_ms=split)


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------
#: name -> factory(**kw) -> WireCodec (kw: block=, bits=, error_feedback=)
CODECS: dict = {}
#: name -> factory(**kw) -> Aggregator
AGGREGATORS: dict = {}
#: name -> factory(chunk=) -> RoundEngine
ENGINES: dict = {}
#: name -> factory(eta0=, decay_rate=) -> LRSchedule
SCHEDULES: dict = {}
#: name -> factory(epsilon=, delta=, cfg_epsilon=) -> SyncPolicy
SYNC_POLICIES: dict = {}


def register_codec(name, factory):
    CODECS[name] = factory
    return factory


def register_aggregator(name, factory):
    AGGREGATORS[name] = factory
    return factory


def register_engine(name, factory):
    ENGINES[name] = factory
    return factory


def register_schedule(name, factory):
    SCHEDULES[name] = factory
    return factory


def register_sync_policy(name, factory):
    SYNC_POLICIES[name] = factory
    return factory


def _leafwise_codec(block=DEFAULT_BLOCK, bits=8, error_feedback=False):
    if bits == 8 and not error_feedback:
        return LeafwiseInt8(block=block)
    return LeafwiseIntN(block=block, bits=bits,
                        error_feedback=error_feedback)


def _flat_codec(block=DEFAULT_BLOCK, bits=8, error_feedback=False):
    if bits == 8 and not error_feedback:
        return FlatFusedInt8(block=block)
    return FlatFusedIntN(block=block, bits=bits,
                         error_feedback=error_feedback)


register_codec("exact", lambda block=DEFAULT_BLOCK, bits=8,
               error_feedback=False: ExactF32())
register_codec("none", CODECS["exact"])
register_codec("leafwise", _leafwise_codec)
register_codec("int8", _leafwise_codec)        # legacy CLI alias
register_codec("fused", _flat_codec)
register_codec("flat", _flat_codec)            # alias
register_aggregator("full", FullAverage)
register_aggregator("partial", PartialParticipation)
register_aggregator("ring", RingGossip)
register_aggregator("graph", GraphGossip)
register_aggregator("d2", D2Gossip)
register_engine("python", lambda chunk=32: PythonEngine())
register_engine("fused", FusedEngine)
register_schedule("clr", lambda eta0=0.01, decay_rate=0.25:
                  CLR(eta0, decay_rate))
register_schedule("elr", lambda eta0=0.01, decay_rate=0.25:
                  ELR(eta0, decay_rate))
register_schedule("warmup_clr", lambda eta0=0.01, decay_rate=0.25:
                  WarmupCLR(eta0, decay_rate))
register_schedule("warmup", SCHEDULES["warmup_clr"])       # alias
register_schedule("cosine", lambda eta0=0.01, decay_rate=0.25:
                  CosineCyclical(eta0))
register_sync_policy("ile", lambda epsilon=None, delta=None,
                     cfg_epsilon=None:
                     ILE(epsilon=next(e for e in (epsilon, cfg_epsilon,
                                                  0.01) if e is not None)))
register_sync_policy("fle", lambda epsilon=None, delta=None,
                     cfg_epsilon=None: FLE())
# ``epsilon`` is an explicit caller value, ``cfg_epsilon`` the config's:
# the trigger's optional doubling engages only when asked for
register_sync_policy("divtrigger", lambda epsilon=None, delta=None,
                     cfg_epsilon=None:
                     DivergenceTrigger(
                         delta=0.05 if delta is None else delta,
                         epsilon=epsilon))
register_sync_policy("divergence", SYNC_POLICIES["divtrigger"])  # alias


def _resolve(spec, registry, default, proto, kind, **kw):
    if spec is None:
        return default()
    if isinstance(spec, proto):
        return spec
    if isinstance(spec, str):
        try:
            factory = registry[spec]
        except KeyError:
            raise KeyError(f"unknown {kind} {spec!r}; registered: "
                           f"{sorted(registry)}") from None
        return factory(**kw)
    raise TypeError(f"{kind} must be None, a registry name, or a "
                    f"{proto.__name__}; got {spec!r}")


def get_codec(spec=None, *, block=DEFAULT_BLOCK, bits=8,
              error_feedback=False) -> WireCodec:
    """None | registry name | WireCodec instance -> WireCodec."""
    return _resolve(spec, CODECS, ExactF32, WireCodec, "codec",
                    block=block, bits=bits, error_feedback=error_feedback)


def get_aggregator(spec=None, **kw) -> Aggregator:
    return _resolve(spec, AGGREGATORS, FullAverage, Aggregator,
                    "aggregator", **kw)


def get_engine(spec=None, *, chunk=32) -> RoundEngine:
    return _resolve(spec, ENGINES, PythonEngine, RoundEngine, "engine",
                    chunk=chunk)


def get_schedule(spec=None, cfg=None, *, eta0=None,
                 decay_rate=None) -> LRSchedule:
    """``None`` resolves the legacy ``cfg.schedule`` string."""
    if spec is None:
        spec = cfg.schedule if cfg is not None else "clr"
    if eta0 is None:
        eta0 = cfg.eta0 if cfg is not None else 0.01
    if decay_rate is None:
        decay_rate = cfg.decay_rate if cfg is not None else 0.25
    return _resolve(spec, SCHEDULES, CLR, LRSchedule, "schedule",
                    eta0=eta0, decay_rate=decay_rate)


def get_sync_policy(spec=None, cfg=None, *, epsilon=None,
                    delta=None) -> SyncPolicy:
    """``None`` resolves the legacy ``cfg.epochs_rule`` string."""
    if spec is None:
        spec = cfg.epochs_rule if cfg is not None else "ile"
    return _resolve(spec, SYNC_POLICIES, ILE, SyncPolicy, "sync policy",
                    epsilon=epsilon, delta=delta,
                    cfg_epsilon=cfg.epsilon if cfg is not None else None)

