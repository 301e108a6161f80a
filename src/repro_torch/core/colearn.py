"""Algorithm 1 — the co-learning protocol, ported from
``repro/core/colearn.py``.

A ``CoLearner`` composes the strategy objects of ``core/api.py`` (codec,
aggregator, round engine, schedule, sync policy) and drives rounds:
T_i local epochs of SGD on each of K participants stacked on one device,
the Eq. 2 average over the codec's wire, the Eq. 4 relative change and
the next T_i. The params live on ``device`` (the card unless the caller
passes ``"cpu"``) and are updated in place.

The round engine is ``PythonEngine`` (a host loop, one epoch at a time)
by default or ``FusedEngine`` (every round as replays of CUDA graphs
captured once on the card; ``set_schedule`` swaps among the built-in
schedules without a new capture). Ragged shards train under a batch mask
(``batch_mask``), a weightless ``PartialParticipation`` takes the shard
sizes (``shard_sizes``), and a divergence-gated sync policy skips the
aggregation and the wire on quiet rounds. Elastic membership (``churn``,
``core/membership.py``): the round's liveness row rides into both
engines, dead slots are identity carries, the aggregators renormalise
over the live set (``liveness_aware``), and a slot that joins
warm-starts from the last synced shared model; a static schedule keeps
the static path bit for bit.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import api, averaging, engine as engine_mod
from repro_torch.core import membership as membership_mod
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.tree import leaves, tree_map


@dataclass
class RoundLog:
    round: int
    T: int
    lr_first: float
    lr_last: float
    rel_change: float        # Eq. 4 metric; the divergence on quiet rounds
    local_losses: list       # per local epoch: mean loss over the K slots
    comm_bytes: int          # 0 on rounds a gated sync policy skipped
    synced: bool = True
    live: int = -1           # live participants this round (K: static)
    # device ms of the round's local epochs and of its finalize (Eq. 2,
    # Eq. 4): a fused round replayed as one graph while tracing is on
    # (``repro_torch.spans``); None otherwise
    epochs_ms: float | None = None
    finalize_ms: float | None = None


@dataclass
class CoLearner:
    """K-participant co-learning loop over (codec, aggregator, engine).

    ``loss_fn(params, batch) -> (loss, metrics)`` for ONE participant.
    Each strategy argument takes an object from ``core/api.py``, a
    registry name, or None for the paper-faithful default (exact f32
    wire, full Eq. 2 averaging, python engine, and the ``cfg.schedule`` /
    ``cfg.epochs_rule`` strings)."""
    cfg: Any                                  # CoLearnConfig
    loss_fn: Callable
    optimizer_name: str = "sgd"
    codec: Any = None
    aggregator: Any = None
    round_engine: Any = None
    schedule: Any = None
    sync_policy: Any = None
    device: Any = None
    #: per-participant example counts (``ParticipantData.sizes``): a
    #: ``PartialParticipation`` without weights takes them as its FedAvg
    #: weights, so unequal shards never fall back to a uniform average
    shard_sizes: Any = None
    #: ``(K, n_batches)`` bool validity mask for ragged shards
    #: (``ParticipantData.batch_mask``); None = equal shards, the unmasked
    #: path. Kept as one device tensor that both engines read.
    batch_mask: Any = None
    #: elastic membership: a ``membership.ChurnSchedule``, a registry name
    #: ("none" | "scripted" | "random") or None. A static schedule keeps
    #: the learner on the static-K path, bit for bit; an active one
    #: threads the (K,) liveness row through the engines.
    churn: Any = None
    #: False = the ablation baseline: keep the STATIC mixing matrix under
    #: churn (dead rows' stale models enter the mean) while the engines'
    #: identity carries still apply. True renormalises over the live set.
    liveness_aware: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.codec = api.get_codec(self.codec)
        self.aggregator = api.get_aggregator(self.aggregator)
        self._round_stateful = (getattr(self.codec, "stateful", False)
                                or self.aggregator.stateful)
        K = self.cfg.n_participants
        # topology-backed aggregators reject graphs that can never reach
        # consensus at this K up front
        validate = getattr(self.aggregator, "validate", None)
        if validate is not None:
            validate(K)
        self.round_engine = api.get_engine(self.round_engine)
        self.schedule = api.get_schedule(self.schedule, self.cfg)
        self.sync_policy = api.get_sync_policy(self.sync_policy, self.cfg)
        self.churn = membership_mod.get_churn(self.churn)
        # a static schedule bypasses the membership machinery entirely
        self._churn_active = not self.churn.is_static
        if self.shard_sizes is not None:
            self.shard_sizes = tuple(int(s) for s in self.shard_sizes)
            if len(self.shard_sizes) != K:
                raise ValueError(
                    f"shard_sizes has {len(self.shard_sizes)} entries for "
                    f"K={K} participants")
            if (isinstance(self.aggregator, api.PartialParticipation)
                    and self.aggregator.weights is None):
                self.aggregator = dataclasses.replace(
                    self.aggregator, weights=self.shard_sizes)
        if self.batch_mask is not None:
            mask = np.asarray(self.batch_mask, bool)
            if mask.ndim != 2 or mask.shape[0] != K:
                raise ValueError(
                    f"batch_mask must be (K={K}, n_batches); got shape "
                    f"{mask.shape}")
            if not mask.any(axis=1).all():
                raise ValueError("batch_mask leaves some participant with "
                                 "zero valid batches")
            self.batch_mask = engine_mod.stage(mask, bool, self.device)
        self.opt = get_optimizer(self.optimizer_name)
        self._epoch = engine_mod.make_epoch_fn(
            self.loss_fn, self.opt, masked=self.batch_mask is not None,
            live=self._churn_active)
        # dynamic: the matrix renormalises over the live set every round
        self._aggregate_fn = self.aggregator.make_aggregate_fn(
            self.codec, dynamic=self._churn_active and self.liveness_aware)
        self._comm_cache = None
        self._weights = self._weights_np = None
        self._runner = self.round_engine.bind(self)

    @classmethod
    def from_flags(cls, cfg, loss_fn, *, optimizer_name: str = "sgd",
                   compress_fn: Callable | None = None,
                   engine: str = "python", fused_chunk: int = 32,
                   compress: str | None = None, compress_block: int = 256,
                   aggregator=None, device=None):
        """The legacy flag surface, mapped onto strategy objects:
        ``engine`` ("python" | "fused", with ``fused_chunk``) -> the round
        engine; ``compress`` (None | "leafwise" | "fused", with
        ``compress_block``) -> the codec; ``compress_fn`` an opaque
        stacked -> stacked wire transform (:class:`api.CustomFn`), not
        together with ``compress="fused"``."""
        if engine not in ("python", "fused"):
            raise ValueError(f"unknown engine {engine!r}")
        if compress not in (None, "leafwise", "fused"):
            raise ValueError(f"unknown compress {compress!r}")
        if compress == "fused":
            if compress_fn is not None:
                raise ValueError(
                    "compress='fused' replaces compress_fn entirely; "
                    "pass one or the other")
            codec = api.FlatFusedInt8(block=compress_block)
        elif compress_fn is not None:
            codec = api.CustomFn(compress_fn)
        elif compress == "leafwise":
            codec = api.LeafwiseInt8(block=compress_block)
        else:
            codec = api.ExactF32()
        round_engine = (api.FusedEngine(chunk=fused_chunk)
                        if engine == "fused" else api.PythonEngine())
        return cls(cfg, loss_fn, optimizer_name=optimizer_name, codec=codec,
                   aggregator=aggregator, round_engine=round_engine,
                   device=device)

    # -- Algorithm 1 ---------------------------------------------------------
    def init(self, params):
        K = self.cfg.n_participants
        self._comm_cache = None
        params = tree_map(lambda t: t.to(self.device), params)
        stacked = averaging.stack_participants(params, K)
        # membership starts at the schedule's round-0 mask, so standby
        # slots log no synthetic leave; a static run carries all-live
        if self._churn_active:
            mem = membership_mod.Membership(live=tuple(
                bool(a) for a in self.churn.live_mask(0, K)))
        else:
            mem = membership_mod.Membership.all_live(K)
        return {"params": stacked,
                "opt": engine_mod.init_stacked_opt(self.opt, stacked),
                "ctrl": self.sync_policy.init_state(self.cfg.T0),
                "round": 0, "global_epoch": 0, "prev_avg": None, "log": [],
                "membership": mem,
                "residual": self.aggregator.init_round_state(self.codec,
                                                             stacked)}

    def epochs_budget(self, state):
        """The ELR anneal denominator for the round about to run."""
        return self.sync_policy.epochs_budget(
            state["ctrl"].T, state["round"], state["global_epoch"],
            self.cfg.max_rounds)

    def set_schedule(self, spec):
        """Swap the learning-rate schedule mid-run.

        All built-in schedules share one device body, so swapping among
        them (or re-parameterising one) replays the fused engine's
        captured graphs: the new parameters ride in with the next round's
        parameter pack. A custom schedule with its own ``traced_lr``
        rebinds the engine, whose graphs are then captured anew."""
        self.schedule = api.get_schedule(spec, self.cfg)
        # compare against the runner's captured body (not the previous
        # schedule attribute) so a swap also repairs a direct assignment
        bound = getattr(self._runner, "_traced_lr", None)
        if bound is not None and api.traced_body(self.schedule) is not bound:
            self._runner = self.round_engine.bind(self)
        return self

    def set_sync_policy(self, spec):
        """Swap the sync policy mid-run. Another ε or δ only changes the
        host's values (δ rides into the gate graph through a static
        buffer), so the captured graphs stay; turning the divergence gate
        on or off, or a policy with another traced gate, rebinds the
        fused engine, whose graphs are then captured anew."""
        bound_gated = getattr(self._runner, "_gated", None)
        bound_gate = getattr(self._runner, "_traced_gate", None)
        self.sync_policy = api.get_sync_policy(spec, self.cfg)
        if bound_gated is not None and (
                self.sync_policy.divergence_gated != bound_gated
                or type(self.sync_policy).traced_should_sync
                is not bound_gate):
            self._runner = self.round_engine.bind(self)
        return self

    def param_bytes(self, state):
        """Raw bytes of one participant's model."""
        return api.participant_bytes(state["params"])

    def round_weights(self, round_index, state=None):
        """The aggregator's (K, K) mixing matrix for this round as a device
        tensor (None for statically-known schemes, e.g. Eq. 2). It lives in
        one static buffer, staged again only when the matrix changes, so
        the fused engine's graphs read it at one address. Under active
        churn with ``liveness_aware`` the matrix renormalises over the
        round's live set (``state["membership"]``), so a matrix is always
        produced."""
        K = self.cfg.n_participants
        if self._churn_active and self.liveness_aware:
            live = (state["membership"].live_mask() if state is not None
                    else None)
            w = self.aggregator.mixing_matrix(round_index, K, live=live)
        elif not self.aggregator.uses_weights:
            return None
        else:
            w = self.aggregator.mixing_matrix(round_index, K)
        # a copy: a cached matrix is read-only
        w = np.array(w, np.float32)
        if self._weights_np is None or not np.array_equal(w,
                                                          self._weights_np):
            if self._weights is None or self._weights.shape != w.shape:
                self._weights = torch.empty(w.shape, dtype=torch.float32,
                                            device=self.device)
            self._weights.copy_(engine_mod.stage(w, device=self.device))
            self._weights_np = w
        return self._weights

    def _live_np(self, state):
        """The round's bool (K,) liveness row (None on the static path:
        the engines then run the static graphs)."""
        if not self._churn_active:
            return None
        return state["membership"].live_mask()

    def _round_delta(self, state):
        """The round's divergence threshold: the policy's, moved by this
        round's membership events (a join forces the sync, so the joined
        slot gets the current shared model)."""
        events = (state["membership"].round_events(state["round"])
                  if self._churn_active else ())
        return self.sync_policy.round_delta(events)

    def run_round(self, state, epoch_batches_fn, on_round_end=None):
        """One communication round. ``epoch_batches_fn(round, epoch)``
        returns the ``(K, n_batches, B, ...)`` tensors of that local epoch
        on the learner's device; each participant sees only its own shard.

        Under active churn the membership advances FIRST: the schedule's
        round mask is stepped into ``state["membership"]`` (logging joins
        and leaves) and every slot that joined this round warm-starts from
        the last synced shared model, in place, before any epoch runs.

        ``on_round_end(learner, state)``, when given, fires after the
        round's state transition lands — the publication hook for
        continuous operation (e.g. ``ModelBank.publish_from``). Its return
        value is ignored; the round's state is returned unchanged. On the
        fused engine the state's tensors are the captured graphs' bound
        storage, so a hook only reads them (a clone, as ``publish_from``
        makes, captures nothing)."""
        if self._churn_active:
            i = state["round"]
            new_live = self.churn.live_mask(i, self.cfg.n_participants)
            if not np.any(new_live):
                raise ValueError(
                    f"churn schedule {self.churn.name!r} leaves zero live "
                    f"participants at round {i}")
            state["membership"] = state["membership"].step(i, new_live)
            for k in state["membership"].joined(i):
                self.restart_participant(state, k)
        state = self._runner.run_round(state, epoch_batches_fn)
        if on_round_end is not None:
            on_round_end(self, state)
        return state

    def _finish_round(self, state, i, T_i, rel, local_losses, lr_first,
                      lr_last, averaged, fresh_opt, new_avg, synced=True,
                      residual=None, device_ms=None):
        """The one round state transition (opt state is reset, not
        averaged: local training restarts from the shared model). On a
        round a gated policy skipped (``synced=False``) the runner passes
        the untouched local params and optimizer state, the unchanged
        sync reference and the divergence as ``rel``, and the round bills
        zero bytes. A round-independent bill is priced once per learner;
        under active churn the live set moves the bill every round.
        ``device_ms``: the round's (epochs ms, finalize ms), or None."""
        state["params"], state["opt"] = averaged, fresh_opt
        state["prev_avg"] = new_avg
        if residual is not None:
            state["residual"] = residual
        if self._churn_active:
            mem = state["membership"]
            events, n_live = mem.round_events(i), mem.n_live
        else:
            events, n_live = (), self.cfg.n_participants
        state["ctrl"] = self.sync_policy.update(state["ctrl"], i, rel,
                                                synced, events=events)
        state["global_epoch"] += T_i
        if not synced:
            comm = 0
        elif self._churn_active:
            comm = self.aggregator.comm_bytes(
                self.codec, state["params"], i,
                live=state["membership"].live_mask())
        elif self.aggregator.static_comm:
            if self._comm_cache is None:
                self._comm_cache = self.aggregator.comm_bytes(
                    self.codec, state["params"], i)
            comm = self._comm_cache
        else:
            comm = self.aggregator.comm_bytes(self.codec, state["params"], i)
        state["round"] = i + 1
        epochs_ms, finalize_ms = device_ms or (None, None)
        state["log"].append(RoundLog(i, T_i, lr_first, lr_last, rel,
                                     local_losses, comm, synced,
                                     live=n_live, epochs_ms=epochs_ms,
                                     finalize_ms=finalize_ms))
        return state

    # handles on the fused engine's captured functions (their ``captures``
    # and ``replays`` counts are what the tests pin)
    def _fused_handle(self, attr):
        if not hasattr(self._runner, attr):
            raise AttributeError(
                f"_fused{attr} is only available with "
                f"round_engine=FusedEngine(); this learner runs "
                f"{self.round_engine.name!r}")
        return getattr(self._runner, attr)

    @property
    def _fused_round(self):
        return self._fused_handle("_round")

    @property
    def _fused_epochs(self):
        return self._fused_handle("_epochs")

    @property
    def _fused_finalize(self):
        return self._fused_handle("_finalize")

    def _first_live(self, state):
        live = self._live_np(state)
        return 0 if live is None else int(np.argmax(live))

    def shared_model(self, state):
        """A copy of the shared model: the first LIVE slot after a synced
        round (a dead slot 0 holds its stale pre-crash model)."""
        return averaging.unstack_participant(state["params"],
                                             self._first_live(state))

    def _sync_ref(self, state):
        """The last synced shared model (a copy of the first live slot
        before the first sync): the Eq. 4 and divergence reference of both
        engines."""
        if state["prev_avg"] is not None:
            return state["prev_avg"]
        return averaging.unstack_participant(state["params"],
                                             self._first_live(state))

    # -- failure handling (paper: restart the participant's local training) --
    @torch.no_grad()
    def restart_participant(self, state, k):
        """Reset participant k's params AND optimizer row to the last synced
        shared model (``_sync_ref``, not slot 0: gossip rows differ, and a
        quiet round leaves slot 0 drifted), and zero its round-state row
        (error-feedback residual and/or D² correction). Everything is
        written into the state's storage, so the fused engine's graphs
        stay valid."""
        shared = self._sync_ref(state)
        for dst, src in zip(leaves(state["params"]), leaves(shared)):
            dst[k].copy_(src)
        fresh = self.opt.init(shared)
        for dst, src in zip(leaves(state["opt"]), leaves(fresh)):
            dst[k].copy_(src)
        if self._round_stateful and state.get("residual") is not None:
            for e in leaves(state["residual"]):
                e[k].zero_()
        return state
