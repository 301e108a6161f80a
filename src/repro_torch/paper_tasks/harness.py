"""Shared harness for the paper-claims runs, ported from
``benchmarks/harness.py``: vanilla learning (centralized), ensemble
learning and co-learning (any CLR/ELR × ILE/FLE combination) on a
classification task, with accuracy per round.

Every entry point takes ``device=`` (None -> the card; without one it
raises unless ``"cpu"`` is asked for). ``init_fn`` receives a
``torch.Generator`` seeded with ``seed`` on that device and may return
params on any device (the learner moves them). Batches go to the device
through ``core/engine.stage``; the result dicts have the reference's keys.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs.base import CoLearnConfig
from repro_torch.core import api
from repro_torch.core.colearn import CoLearner
from repro_torch.core.engine import stage
from repro_torch.core.ensemble import ensemble_accuracy
from repro_torch.core.schedule import round_lr
from repro_torch.data import partition as part_mod
from repro_torch.data.partition import partition_arrays
from repro_torch.data.pipeline import ParticipantData
from repro_torch.device import resolve_device
from repro_torch.models.layers import softmax_xent
from repro_torch.tree import leaves, tree_map


def build_participant_data(train, K, batch_size, seed, *, partition="iid",
                           dirichlet_alpha=1.0, sizes=None, k_max=None):
    """Shard (x, y) under a data scenario -> ``ParticipantData``.

    partition: "iid" (the paper's random split, remainder round-robin) |
    "dirichlet" (label-skew non-IID over y, ``dirichlet_alpha``) |
    "sizes" (quantity skew, ``sizes`` counts/fractions), dispatched by
    ``data/partition.scenario_indices`` as in ``launch/train.py``.
    """
    x, y = train
    idx = part_mod.scenario_indices(
        len(x), K, seed, scenario=partition, labels=y,
        dirichlet_alpha=dirichlet_alpha, sizes=sizes, min_size=batch_size)
    shards = part_mod.shard_by_indices([x, y], idx)
    return ParticipantData(shards, batch_size, seed, k_max=k_max)


def cls_loss(apply_fn):
    def loss_fn(params, batch):
        x, y = batch
        logits = apply_fn(params, x)
        loss = softmax_xent(logits[:, None, :], y[:, None].long())
        return loss, {"loss": loss}
    return loss_fn


def _epoch_batches(data, steps_cap, dev):
    """``epoch_batches_fn(round, epoch)`` over ``data``: each epoch's
    ``(K, n_batches, B, ...)`` arrays (cut to ``steps_cap`` batches)
    staged to ``dev``, the labels as int64."""
    def eb(i_, j_):
        bx, by = data.epoch_batches(i_, j_)
        if steps_cap:
            bx, by = bx[:, :steps_cap], by[:, :steps_cap]
        return stage(bx, device=dev), stage(by, np.int64, dev)
    return eb


@torch.no_grad()
def accuracy(apply_fn, params, x, y, bs=256):
    """Top-1 accuracy of ``params`` on host arrays ``(x, y)``, evaluated on
    the params' device ``bs`` examples at a time (one host sync)."""
    dev = leaves(params)[0].device
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(0, len(x), bs):
        lg = apply_fn(params, stage(x[i:i + bs], device=dev))
        correct += (torch.argmax(lg, -1)
                    == stage(y[i:i + bs], device=dev)).sum()
    return int(correct) / len(x)


def run_colearn(init_fn, apply_fn, train, test, *, K=5, rounds=6, T0=1,
                eta0=0.02, epsilon=0.02, schedule="clr", epochs_rule="ile",
                batch_size=32, seed=0, steps_cap=0, engine="python",
                compress=None, codec=None, aggregator=None,
                lr_schedule=None, sync_policy=None, partition="iid",
                dirichlet_alpha=1.0, sizes=None, weighted=False,
                churn=None, liveness_aware=True, k_max=None,
                drift=None, stream=None, on_round_end=None, device=None):
    """Returns dict with per-round accuracy, controller history, comm stats.

    engine: "python" (the host loop, one epoch at a time) or "fused" (every
    round as replays of CUDA graphs captured once on the card, see
    ``core/engine.py``); identical results. codec / aggregator /
    lr_schedule / sync_policy: round-strategy objects or registry names
    (``core/api.py``) — e.g. codec="leafwise" | "fused",
    aggregator=PartialParticipation(m=2) | "ring",
    sync_policy=DivergenceTrigger(delta=0.1). lr_schedule/sync_policy left
    as None resolve the schedule/epochs_rule strings through the same
    registries. compress is the legacy alias for codec (None | "leafwise"
    | "fused").

    Data scenario: ``partition`` / ``dirichlet_alpha`` / ``sizes`` pick the
    split (see ``build_participant_data``); ``weighted=True`` switches
    Eq. 2 to the example-count-weighted FedAvg average
    (``FullAverage(weights=shard sizes)``; default aggregator only).
    Ragged shards thread their validity mask into the engines, and the
    shard sizes are handed to the learner so partial participation weights
    by them.

    Elastic membership: ``churn`` takes a ``core/membership.py`` schedule
    (or registry name) injecting per-round participant failures;
    ``liveness_aware=False`` keeps the static mixing matrix under churn
    (the naive ablation — dead rows pollute the mean); ``k_max`` reserves
    standby slots beyond K (the extra slots cycle the real shards). The
    result's ``live`` holds the per-round live counts.

    Continuous operation: ``drift`` takes a ``data/stream.py`` schedule
    (or registry name) and stages each round on a drifting ``ShardStream``
    instead of the frozen stack — per-round accuracy is then measured on
    the test set AS THAT ROUND'S DISTRIBUTION SEES IT (``transform_test``),
    the honest serving metric under drift. ``stream`` passes a prebuilt
    ``ShardStream`` directly (overrides the partition kwargs).
    ``on_round_end(learner, state)`` fires after every round's state
    transition — the ``ModelBank.publish_from`` hook.
    """
    dev = resolve_device(device)
    if compress is not None:
        if codec is not None:
            raise ValueError("pass codec= or the legacy compress=, not both")
        codec = compress
    if stream is not None:
        if drift is not None:
            raise ValueError("pass stream= (prebuilt) or drift=, not both")
        data = stream
    elif drift is not None:
        from repro_torch.data.stream import ShardStream
        data = ShardStream(list(train), K, batch_size, seed, drift=drift,
                           partition=partition,
                           dirichlet_alpha=dirichlet_alpha, sizes=sizes,
                           k_max=k_max)
    else:
        data = build_participant_data(train, K, batch_size, seed,
                                      partition=partition,
                                      dirichlet_alpha=dirichlet_alpha,
                                      sizes=sizes, k_max=k_max)
    if k_max is not None:
        K = k_max
    if weighted:
        if aggregator is not None:
            raise ValueError("weighted=True builds the FullAverage "
                             "aggregator; pass one or the other")
        aggregator = api.FullAverage(weights=data.sizes)
    batch_mask = data.batch_mask if data.ragged else None
    if batch_mask is not None and steps_cap:
        batch_mask = batch_mask[:, :steps_cap]
    ccfg = CoLearnConfig(n_participants=K, T0=T0, eta0=eta0, epsilon=epsilon,
                         schedule=schedule, epochs_rule=epochs_rule,
                         max_rounds=rounds)
    learner = CoLearner(ccfg, cls_loss(apply_fn), codec=codec,
                        aggregator=aggregator, round_engine=engine,
                        schedule=lr_schedule, sync_policy=sync_policy,
                        shard_sizes=data.sizes, batch_mask=batch_mask,
                        churn=churn, liveness_aware=liveness_aware,
                        device=dev)
    params = init_fn(torch.Generator(device=dev).manual_seed(seed))
    state = learner.init(params)
    eb = _epoch_batches(data, steps_cap, dev)
    accs, Ts, times = [], [], []
    for _ in range(rounds):
        t0 = time.time()
        state = learner.run_round(state, eb, on_round_end=on_round_end)
        times.append(time.time() - t0)
        Ts.append(state["log"][-1].T)
        # under drift, score against the test set as THIS round's
        # distribution sees it (content drift moves the eval too)
        round_test = (data.transform_test(test, state["round"])
                      if hasattr(data, "transform_test") else test)
        accs.append(accuracy(apply_fn, learner.shared_model(state),
                             *round_test))
    # per-round wire cost of a SYNCED round (round 0 may be quiet and bill
    # 0 under a divergence-gated policy); totals cover the whole run
    per_round = next((l.comm_bytes for l in state["log"] if l.synced), 0)
    return {"acc": accs, "T": Ts, "round_s": times,
            "shard_sizes": data.sizes,
            "live": [l.live for l in state["log"]],
            "comm_bytes": per_round,
            "total_comm_bytes": sum(l.comm_bytes for l in state["log"]),
            "synced_rounds": sum(1 for l in state["log"] if l.synced),
            "history": state["ctrl"].history,
            "final_params": learner.shared_model(state), "state": state,
            "learner": learner}


def run_vanilla(init_fn, apply_fn, train, test, *, epochs=6, eta0=0.02,
                batch_size=32, seed=0, schedule="elr", steps_cap=0,
                device=None):
    """Centralized baseline: K=1, all data, ELR (paper's vanilla setting)."""
    return run_colearn(init_fn, apply_fn, train, test, K=1, rounds=epochs,
                       T0=1, eta0=eta0, epsilon=0.0, schedule=schedule,
                       epochs_rule="fle", batch_size=batch_size, seed=seed,
                       steps_cap=steps_cap, device=device)


def run_ensemble(init_fn, apply_fn, train, test, *, K=5, epochs=6, eta0=0.02,
                 batch_size=32, seed=0, steps_cap=0, device=None):
    """Paper's ensemble baseline: independent local training, avg outputs."""
    dev = resolve_device(device)
    x, y = train
    shards = partition_arrays([x, y], K, seed)
    data = ParticipantData(shards, batch_size, seed)
    ccfg = CoLearnConfig(n_participants=K, T0=epochs, eta0=eta0,
                         epsilon=0.0, schedule="clr", epochs_rule="fle",
                         max_rounds=1)
    learner = CoLearner(ccfg, cls_loss(apply_fn), device=dev)
    state = learner.init(init_fn(torch.Generator(device=dev)
                                 .manual_seed(seed)))

    # one "round" of T0=epochs local epochs, but NO averaging: the
    # learner's own epoch function on the participant replicas
    eb = _epoch_batches(data, steps_cap, dev)
    cfg = learner.cfg
    for j in range(cfg.T0):
        lr = float(round_lr(cfg, 0, j, cfg.T0, j, cfg.T0))
        state["params"], state["opt"], _ = learner._epoch(
            state["params"], state["opt"], eb(0, j), lr)
    xt, yt = test
    with torch.no_grad():
        acc = float(ensemble_accuracy(apply_fn, state["params"],
                                      stage(xt, device=dev),
                                      stage(yt, device=dev)))
    # per-participant local accuracies for reference
    local = [accuracy(apply_fn, tree_map(lambda t, _k=k: t[_k],
                                         state["params"]), xt, yt)
             for k in range(K)]
    return {"acc": acc, "local_acc": local}
